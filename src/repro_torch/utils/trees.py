"""Helpers over trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port of ``repro.utils.trees`` (which walks JAX pytrees), plus the
``tree_leaves``/``tree_map`` the models use in place of
``jax.tree_util``. Dict leaves come in sorted key order, as JAX's do.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(x.shape == y.shape and torch.allclose(x, y, rtol=rtol, atol=atol)
               for x, y in zip(la, lb))
