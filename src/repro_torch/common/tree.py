"""Small tree helpers used by the trainer and checkpointing: the port of
``repro.common.tree``.

A tree is nested dicts, lists and tuples (NamedTuples included) whose
leaves are tensors, numpy arrays or scalars; ``None`` is an empty subtree,
as in JAX. Leaves come in JAX's order: dict keys sorted, sequences by
index. A leaf's path joins its keys with ``/``: a dict key as itself, a
sequence index as its number, a NamedTuple field by its name, so a path
names a leaf as the reference's ``flatten_with_paths`` names it in the
same structure (the port's params hold a ``layers`` list where the
reference stacks ``units``; ``models.bridge`` maps one onto the other,
leaf names unchanged).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> List[Tuple[str, Any]]:
    """(key, subtree) pairs of an inner node, in flattening order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _rebuild(tree: Any, values: List[Any]) -> Any:
    """An inner node like ``tree`` holding ``values`` (in ``_children``
    order)."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def _is_inner(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """Flatten a tree into ``(path, leaf)`` pairs (stable order)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        if _is_inner(node):
            for key, child in _children(node):
                walk(child, prefix + (key,))
        else:
            out.append(("/".join(prefix), node))

    walk(tree, ())
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       *rest: Any) -> Any:
    """``fn(path, leaf, *leaves of rest)`` over every leaf of ``tree``; the
    trees of ``rest`` share its structure."""
    def walk(node, others, prefix):
        if node is None:
            return None
        if _is_inner(node):
            kids = _children(node)
            other_kids = [[c for _, c in _children(o)] for o in others]
            return _rebuild(node, [
                walk(child, [ok[i] for ok in other_kids], prefix + (key,))
                for i, (key, child) in enumerate(kids)])
        return fn("/".join(prefix), node, *others)

    return walk(tree, list(rest), ())


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over every leaf (``jax.tree.map``)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, as a 0-dim
    tensor on the leaves' device (no host sync)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(tree: Any) -> Any:
    return tree_map(_numpy, tree)


def tree_size_report(tree: Any, top: int = 12) -> str:
    rows = sorted(flatten_with_paths(tree),
                  key=lambda kv: -int(np.prod(kv[1].shape)))[:top]
    return "\n".join(
        f"  {k:60s} {tuple(v.shape)} {str(v.dtype).replace('torch.', '')}"
        for k, v in rows)


def named_dict(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in flatten_with_paths(tree)}
