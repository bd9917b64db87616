"""PyTorch/CUDA port of the ``repro`` package.

The port mirrors ``src/repro/`` module for module and imports nothing from
it (nor JAX): host-side NumPy modules are copies, held to the originals by
``tests/test_torch_*.py``. Slice 1 carries the online serving path, whose
neighbour aggregation runs a hand-written CUDA kernel on the card
(``repro_torch.kernels.seg_aggregate``).
"""
