# The paper's compute hot-spots as hand-written Hopper kernels:
#   seg_aggregate — blocked-ELL neighbour aggregation (paper §4 index_add/SpMM)
#                   over the degree-bucketed layout, forward (csrc/seg_aggregate.cu)
# quant_pack / dequant_unpack arrive with the training slice.
from repro_torch.kernels.ops import padded_device_bucketed
from repro_torch.kernels.seg_aggregate import (
    DeviceBucketedEll,
    DeviceEllBucket,
    bucketed_aggregate,
    device_bucketed,
)

__all__ = [
    "DeviceBucketedEll",
    "DeviceEllBucket",
    "bucketed_aggregate",
    "device_bucketed",
    "padded_device_bucketed",
]
