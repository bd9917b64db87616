"""PyTorch/CUDA port of the ``repro`` package.

The port mirrors ``src/repro/`` module for module and imports nothing from
it (nor JAX): host-side NumPy modules are copies, held to the originals by
``tests/test_torch_*.py``. It serves (``serve``), trains on one device
(``core.trainer.train_gcn_single``) and trains the paper's distributed
schedule with its workers stacked on one device (``run.build_session``),
GraphSAGE, GCN, GIN and, except distributed, GAT; runs checkpoint in the
JAX package's format (``checkpoint``). The neighbour aggregation and the
quantized wire run hand-written CUDA kernels on the card (``kernels``).
"""
