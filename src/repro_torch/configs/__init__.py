"""Config registry: the paper's GraphSAGE presets and the serving and
training configurations built on them (their own modules), plus the 10
LM architectures and input shapes of ``repro.configs``.

Every architecture config cites its source in ``source``. ``get_arch(name)``
returns the full production config; ``get_smoke_arch(name)`` the reduced
same-family variant (2 layers, d_model<=512, <=4 experts). The port serves
all ten.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape
from repro_torch.models.transformer import ArchConfig

ARCH_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "starcoder2-3b": "starcoder2_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-2.7b": "zamba2_2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-350m": "xlstm_350m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "whisper-small": "whisper_small",
}

ARCH_NAMES = list(ARCH_MODULES)


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_arch(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_arch(name: str) -> ArchConfig:
    return _module(name).SMOKE


__all__ = ["ARCH_MODULES", "ARCH_NAMES", "get_arch", "get_smoke_arch",
           "INPUT_SHAPES", "InputShape", "get_shape", "ArchConfig"]
