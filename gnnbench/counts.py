"""The yardstick's arithmetic: the table of peaks, and the operations and
bytes the work needs, counted from the graph and the widths alone (not
from any layout of the program), so that a change of layout moves the
time and not the count."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

# Published peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit):
# fp32 outside the tensor cores (the configurations keep TF32 off) and
# HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def dims(model: Dict) -> List[int]:
    return ([model["in_dim"]] + [model["hidden_dim"]] * (model["num_layers"] - 1)
            + [model["num_classes"]])


def edges(raw: Dict) -> int:
    """Aggregated edges: the graph's, plus the self loop of every node."""
    return int(len(raw["src"])) + int(raw["num_nodes"])


def sage_flops(model: Dict, n: int, e: int) -> float:
    """One training step of GraphSAGE: per layer the two dense products
    (2·n·d_in·d_out each) forward and twice that backward, and the
    aggregation's 2·e·d_in each way. Recompute is not counted."""
    d = dims(model)
    return sum(12.0 * n * a * b + 4.0 * e * a for a, b in zip(d, d[1:]))


def gat_flops(model: Dict, n: int, e: int) -> float:
    """One training step of GAT: per layer the dense product (2·n·d_in·d_out
    forward, twice that backward), the two attention dot products (2·n·d_out
    each, twice that backward), per edge and head the score's add, the
    leaky ReLU and the softmax's exp, sum and division (5 forward, 10
    backward), and the weighted sum (2·e·d_out forward, 4·e·d_out backward:
    the gradients in the weights and in the rows)."""
    d, h = dims(model), model["heads"]
    return sum(6.0 * n * a * b + 12.0 * n * b + 15.0 * e * h + 6.0 * e * b
               for a, b in zip(d, d[1:]))


def aggregation_bytes(model: Dict, n: int, e: int) -> float:
    """One training step's aggregations: per layer, forward and backward,
    each of the n source rows read once, each of the n output rows written
    once (fp32 at the layer's input width) and 8 B per edge (its source id
    and weight)."""
    return sum(2.0 * (8.0 * e + 8.0 * n * a) for a in dims(model)[:-1])


def int2_wire_bytes(model: Dict, rows: int, bits: int) -> float:
    """One refresh step's quantizer work on a wire of ``rows`` rows (over
    all workers): per layer, forward and backward, ``quant_pack`` reads each
    fp32 value and its uniform once and writes each packed word and each
    4-row group's fp32 zero and scale once; ``dequant_unpack`` reads those
    and writes each fp32 value once."""
    total = 0.0
    for f in dims(model)[:-1]:
        values = rows * f * 4.0
        packed = rows * math.ceil(f * bits / 32) * 4.0
        params = math.ceil(rows / 4) * 2 * 4.0
        total += 2.0 * ((2 * values + packed + params) + (packed + params + values))
    return total


def kernel_seconds(traced: List[Dict], names, kinds=None) -> float:
    """Device seconds of the traced epochs' activities whose name holds one
    of ``names``, over the epochs of ``kinds`` (all when None)."""
    s = 0.0
    for ep in traced:
        if kinds is not None and ep["kind"] not in kinds:
            continue
        for name, t0, t1 in ep["device"]:
            if any(k in name for k in names):
                s += (t1 - t0) * 1e-6
    return s
