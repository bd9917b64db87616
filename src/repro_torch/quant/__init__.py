# Stochastic quantization of the halo wire (paper §7.3), in PyTorch.
from repro_torch.quant.stochastic import (
    ROW_GROUP,
    QuantParams,
    dequantize,
    dequantize_packed,
    pack_bits,
    quantize,
    quantize_packed,
    unpack_bits,
    wire_bytes,
)

__all__ = [
    "ROW_GROUP",
    "QuantParams",
    "dequantize",
    "dequantize_packed",
    "pack_bits",
    "quantize",
    "quantize_packed",
    "unpack_bits",
    "wire_bytes",
]
