"""The recorded training step the auditor's rules read (counterpart of
``repro.analysis.ir``).

The JAX package lowers a step to StableHLO without running it and parses
the module text into ``HloOp``\\ s. Eager PyTorch has no lowered module,
so the port records one instead (``core.record``): a :class:`StepOp` is
the port's ``HloOp`` and a :class:`LoweredStep` its ``HloModule``, with
``walk``, ``collectives``, ``computes``, ``collective_order`` and
``as_text``. A ``shard_map`` step is a :class:`RankPrograms`, one
``LoweredStep`` per rank, read a rank at a time through ``programs``
(``collective_order`` and ``as_text`` over all of them). They are defined in the
core layer, which records them, and re-exported here.

``parse_stablehlo`` and ``compiled_collectives`` have no counterpart:
there is no module text to parse and no compiled module whose byte
counts could differ from the recorded ones.
"""

from repro_torch.core.record import (  # noqa: F401
    COLLECTIVE_KINDS,
    COMPUTE_KINDS,
    QUANT_KINDS,
    WIRE_START,
    LoweredStep,
    RankPrograms,
    StepOp,
    StepRecorder,
    _klass,
)
