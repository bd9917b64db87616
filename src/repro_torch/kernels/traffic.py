"""The kernel wrappers' own reads and writes, for a byte count.

The wrappers launch their kernels through ctypes, past PyTorch's
dispatcher, so a ``TorchDispatchMode`` (``launch.hlo_stats.analyze_step``)
sees none of their tensors on the card; on the CPU it would see the plain
version's ops instead, intermediates included. While a counter is
registered (:func:`counting`), a wrapper marked :func:`kernel_io` runs its
body, kernel or plain version, with the dispatch modes off, and adds the
bytes of its own tensor operands and results once, so the count is the
same on both devices. With no counter registered it runs as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Iterator, List

import torch
from torch.utils._python_dispatch import _disable_current_modes

_counters: List[Callable[[int], None]] = []


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs``: tensors, tuples and lists (named
    tuples too), dicts, and the init fields of dataclasses (a layout's
    buckets, not its cached tables)."""
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            n += tensor_bytes(*o)
        elif isinstance(o, dict):
            n += tensor_bytes(*o.values())
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            n += tensor_bytes(*(getattr(o, f.name) for f in dataclasses.fields(o)
                                if f.init))
    return n


@contextlib.contextmanager
def counting(add: Callable[[int], None]) -> Iterator[None]:
    """Within the block, every :func:`kernel_io` call adds its bytes with
    ``add``."""
    _counters.append(add)
    try:
        yield
    finally:
        _counters.remove(add)


def kernel_io(fn: Callable) -> Callable:
    """Mark a wrapper as one op that reads its tensor arguments and writes
    its results (module docstring)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _counters:
            return fn(*args, **kwargs)
        with _disable_current_modes():
            out = fn(*args, **kwargs)
        n = tensor_bytes(args, kwargs, out)
        for add in list(_counters):
            add(n)
        return out

    return wrapper
