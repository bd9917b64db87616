# The paper's compute hot-spots as hand-written Hopper kernels:
#   seg_aggregate  — blocked-ELL neighbour aggregation (paper §4 index_add/SpMM)
#                    over the degree-bucketed layout, one graph or a stack of
#                    workers, forward and backward (csrc/seg_aggregate.cu)
#   quant_pack /   — fused stochastic quantize + bit-pack of the halo wire and
#   dequant_unpack   its inverse (paper §7.3; csrc/quant_pack.cu)
from repro_torch.kernels.ops import (aggregate, dequantize_unpack,
                                     padded_device_bucketed, quantize_pack)
from repro_torch.kernels.seg_aggregate import (
    DeviceBucketedEll,
    DeviceEllBucket,
    bucketed_aggregate,
    device_bucketed,
)

__all__ = [
    "aggregate",
    "dequantize_unpack",
    "quantize_pack",
    "DeviceBucketedEll",
    "DeviceEllBucket",
    "bucketed_aggregate",
    "device_bucketed",
    "padded_device_bucketed",
]
