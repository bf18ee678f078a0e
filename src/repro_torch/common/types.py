"""Shared type aliases and dtype policy helpers: the port of
``repro.common.types``."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from repro_torch.common.tree import tree_leaves, tree_map

Params = Any  # tree of tensors

#: dtype policy: params are stored in ``param_dtype`` and compute runs in
#: ``compute_dtype``; the port computes in float32 throughout for now, as
#: the reference's CPU tests do
DEFAULT_PARAM_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.bfloat16


def cast_tree(tree: Params, dtype) -> Params:
    return tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def shape_dtype(tree: Params) -> Dict[str, Any]:
    """The tree's skeleton as tensors on the ``meta`` device (shape and
    dtype, no storage): the counterpart of ``jax.ShapeDtypeStruct``."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


def param_count(tree: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def param_bytes(tree: Params) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def fmt_count(n: int) -> str:
    for unit, div in (("T", 1e12), ("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return str(n)


def fmt_bytes(n: float) -> str:
    for unit, div in (("TiB", 2**40), ("GiB", 2**30), ("MiB", 2**20),
                      ("KiB", 2**10)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}B"


def assert_finite(name: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")


def merge_dicts(*ds: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for d in ds:
        out.update(d)
    return out
