"""Stochastic quantize + bit-pack and its inverse: the hand-written CUDA kernels.

Counterpart of ``repro/kernels/quant_pack.py`` (Pallas ``quant_pack`` and
``dequant_unpack``). ``csrc/quant_pack.cu`` holds both kernels; its header
says what bounds them and how they stay bit-exact with the plain versions
(``ref.quant_pack_ref`` / ``ref.dequant_unpack_ref``).

Two differences from the Pallas pair: the scale is divided, not multiplied
by ``1/levels`` (ROADMAP C-ref2), so the kernel equals the training path's
``quant.stochastic.quantize``; and the feature width need not be a multiple
of ``32 / bits`` (layer 0 of the paper's model exchanges F = 100): a row
packs into ``ceil(F / (32/bits))`` words whose unused fields are zero, and
``dequant_unpack`` takes ``feat``.

Dispatch is by device: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor to the plain version. ``pack_launches`` and
``unpack_launches`` count kernel launches. Both wrappers are
``traffic.kernel_io``: a byte count sees each call as one op on either
device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.traffic import kernel_io
from repro_torch.quant.stochastic import ROW_GROUP, words_per_row

pack_launches = 0     # quant_pack kernel launches since the last reset
unpack_launches = 0   # dequant_unpack kernel launches since the last reset

_BITS = (2, 4, 8)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points of ``csrc/quant_pack.cu``, built on first use."""
    from repro_torch.kernels.build import load

    lib = load("quant_pack")
    pack, unpack = lib.quant_pack_f32, lib.dequant_unpack_f32
    pack.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    unpack.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pack.restype = unpack.restype = ctypes.c_int
    return pack, unpack


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@kernel_io
def quant_pack(x: torch.Tensor, noise: torch.Tensor, bits: int = 2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed [R, ceil(F*bits/32)] int32, zero [R/4], scale [R/4]) of
    ``x`` [R, F] with the stochastic-rounding ``noise`` [R, F]: the kernel
    on CUDA tensors, ``ref.quant_pack_ref`` on CPU tensors."""
    global pack_launches
    if bits not in _BITS:
        raise ValueError(f"quant_pack: bits must be one of {_BITS}, got {bits}")
    if x.dim() != 2 or noise.shape != x.shape or x.shape[0] % ROW_GROUP:
        raise ValueError(f"quant_pack: x {tuple(x.shape)}, noise "
                         f"{tuple(noise.shape)}; rows must be a multiple of {ROW_GROUP}")
    _require(x, "quant_pack: x", torch.float32, x.device)
    _require(noise, "quant_pack: noise", torch.float32, x.device)
    if x.device.type == "cpu":
        return ref.quant_pack_ref(x, noise, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_pack kernel needs CUDA tensors, got {x.device}")
    rows, feat = x.shape
    packed = torch.empty((rows, words_per_row(feat, bits)), dtype=torch.int32,
                         device=x.device)
    zero = torch.empty(rows // ROW_GROUP, dtype=torch.float32, device=x.device)
    scale = torch.empty_like(zero)
    if rows == 0 or feat == 0:
        return packed, zero.zero_(), scale.zero_()
    if x.numel() >= 2**31:
        raise ValueError("quant_pack: sizes beyond the kernel's int32 range")
    err = _kernels()[0](x.data_ptr(), noise.data_ptr(), packed.data_ptr(),
                        zero.data_ptr(), scale.data_ptr(), rows // ROW_GROUP,
                        feat, bits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quant_pack kernel launch failed: CUDA error {err}")
    pack_launches += 1
    return packed, zero, scale


@kernel_io
def dequant_unpack(packed: torch.Tensor, zero: torch.Tensor, scale: torch.Tensor,
                   bits: int, feat: int) -> torch.Tensor:
    """``q * scale + zero`` per 4-row group, [R, feat] fp32: the kernel on
    CUDA tensors, ``ref.dequant_unpack_ref`` on CPU tensors."""
    global unpack_launches
    if bits not in _BITS:
        raise ValueError(f"dequant_unpack: bits must be one of {_BITS}, got {bits}")
    rows = packed.shape[0]
    if (packed.dim() != 2 or rows % ROW_GROUP
            or packed.shape[1] != words_per_row(feat, bits)
            or zero.shape != (rows // ROW_GROUP,) or scale.shape != zero.shape):
        raise ValueError(f"dequant_unpack: packed {tuple(packed.shape)}, zero "
                         f"{tuple(zero.shape)}, scale {tuple(scale.shape)} for "
                         f"feat={feat}, bits={bits}")
    _require(packed, "dequant_unpack: packed", torch.int32, packed.device)
    _require(zero, "dequant_unpack: zero", torch.float32, packed.device)
    _require(scale, "dequant_unpack: scale", torch.float32, packed.device)
    if packed.device.type == "cpu":
        return ref.dequant_unpack_ref(packed, zero, scale, bits, feat)
    if packed.device.type != "cuda":
        raise ValueError(f"dequant_unpack kernel needs CUDA tensors, got {packed.device}")
    out = torch.empty((rows, feat), dtype=torch.float32, device=packed.device)
    if rows == 0 or feat == 0:
        return out
    if out.numel() >= 2**31:
        raise ValueError("dequant_unpack: sizes beyond the kernel's int32 range")
    err = _kernels()[1](packed.data_ptr(), zero.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), rows, feat, bits,
                        torch.cuda.current_stream(packed.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequant_unpack kernel launch failed: CUDA error {err}")
    unpack_launches += 1
    return out
