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



def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel (each wrapper
    counts where it launches its kernel)."""
    from repro_torch.kernels import quant_pack, seg_aggregate
    return {"seg_aggregate": seg_aggregate.launches,
            "seg_aggregate_backward": seg_aggregate.backward_launches,
            "quant_pack": quant_pack.pack_launches,
            "dequant_unpack": quant_pack.unpack_launches}


__all__ = [
    "aggregate",
    "dequantize_unpack",
    "quantize_pack",
    "DeviceBucketedEll",
    "DeviceEllBucket",
    "bucketed_aggregate",
    "device_bucketed",
    "launch_counts",
    "padded_device_bucketed",
]
