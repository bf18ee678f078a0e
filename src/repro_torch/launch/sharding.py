"""Sharding rules: the port of ``repro.launch.sharding``.

The rules are the reference's, verbatim, as pure functions from a leaf's
path and shape to a spec: a tuple with one entry per dim, ``None``
(replicated) or the mesh axis (or tuple of axes) the dim is split over.

* Launch scale (the dry-run): tensor parallelism over ``model`` (the
  attention and MLP projections column- or row-split, embeddings split
  by vocabulary, MoE experts over ``model``), the batch over ``(pod,
  data)``, KV caches split by cache length over ``model``, recurrent
  states by their value dim or width; ``mode="2d"`` also splits the other
  weight dim over ``data``.
* Serving (``engine_param_shardings``, ``engine_cache_pspec``): the same
  parameter rules on a 1-D ``("model",)`` mesh, with every axis that does
  not divide its dim dropped (``_fit_mesh``), and KV caches, dense slabs
  and block pools alike, split by HEAD.

The reference stacks its layers (``"units"/<pos>/...`` with a leading
``n_units`` dim, ``transformer.py:68-100``); the port keeps one subtree
per layer (``"layers"/<i>/...``, ``models/bridge.py``), so its rules see
no stacked dim and give the reference's spec without that leading
``None``. Cache paths are the port's list index and leaf name
(``"<i>/k"``).

In place of ``jax.device_put`` under a ``NamedSharding``, ``shard_tree``
cuts a tree into one tree per rank of a ``("model",)`` mesh, each leaf's
slice on its rank's device; ``bytes_per_device`` counts what a rank holds
under a spec, for the dry-run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.tree import tree_map_with_path
from repro_torch.config.base import ModelConfig

M = "model"

Spec = Tuple


def _base_spec(path: str, eff_ndim: int) -> Spec:
    """Spec for the unstacked dims of a leaf (reference ``:33``)."""
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if name == "embed":
        return (M, None)
    if name == "lm_head":
        return (None, M)
    if name in ("wq", "wk", "wv"):
        return (None, M)
    if name == "wo":
        return (M, None)
    if name in ("w_up", "w_gate") and eff_ndim == 3:   # MoE experts (E,d,f)
        return (M, None, None)
    if name == "w_down" and eff_ndim == 3:             # MoE experts (E,f,d)
        return (M, None, None)
    if name in ("w_up", "w_gate"):
        return (None, M)
    if name == "w_down":
        return (M, None)
    if name == "router":
        return (None, M)
    # RWKV
    if parent == "time_mix":
        if name in ("W_r", "W_k", "W_v", "W_g"):
            return (None, M)
        if name == "W_o":
            return (M, None)
        if name == "u":
            return (None, M)        # (H, hd): shard hd
        if name == "w_base":
            return (M,)
    if parent == "channel_mix":
        if name in ("W_k", "W_r"):
            return (None, M)
        if name == "W_v":
            return (M, None)
    # RG-LRU
    if name in ("W_x",) or (parent == "rec" and name == "W_gate"):
        return (None, M)
    if name in ("W_a", "W_i"):
        return (None, M)
    if parent == "rec" and name == "W_o":
        return (M, None)
    if name == "conv_w":
        return (None, M)
    if name in ("conv_b", "lam", "b_a", "b_i"):
        return (M,)
    if name == "frontend_proj":
        return (None, M)
    # norms, biases, loras, mu_*: replicate
    return tuple(None for _ in range(eff_ndim))


def param_pspec(path: str, leaf, mode: str = "tp",
                data_size: int = 16) -> Spec:
    """A parameter's spec (reference ``:89``). ``mode="2d"`` also splits
    the first replicated dim that ``data_size`` divides over ``data``."""
    ndim = len(leaf.shape)
    spec = _base_spec(path, ndim)
    if len(spec) != ndim:  # rule mismatch -> replicate (safe default)
        spec = tuple(None for _ in range(ndim))
    if mode == "2d" and ndim >= 2:
        spec_l = list(spec)
        for i, s in enumerate(spec_l):
            if s is None and leaf.shape[i] % data_size == 0:
                spec_l[i] = "data"
                break
        spec = tuple(spec_l)
    return spec


def param_shardings(mesh, params, mode: str = "tp") -> Any:
    """``param_pspec`` over a params tree (the reference's
    ``param_shardings``, specs in place of ``NamedSharding``s)."""
    data_size = mesh.shape.get("data", 1)
    return tree_map_with_path(
        lambda path, leaf: param_pspec(path, leaf, mode, data_size), params)


# ---------------------------------------------------------------- inputs
def _batch_spec(mesh, global_batch: int):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if global_batch % n == 0:
        return tuple(axes)
    return None  # e.g. long_500k batch=1: replicate


def input_shardings(mesh, cfg: ModelConfig, specs: Dict,
                    mode: str = "tp") -> Dict:
    """The batch dim of every input over the batch axes, where they
    divide it; ``decode2d`` replicates the batch (reference ``:134``)."""
    out = {}
    for key, leaf in specs.items():
        b_ax = None if mode == "decode2d" else _batch_spec(
            mesh, leaf.shape[0])
        out[key] = (b_ax,) + (None,) * (len(leaf.shape) - 1)
    return out


# ---------------------------------------------------------------- caches
def cache_pspec(path: str, leaf, mesh, batch_axes,
                mode: str = "tp") -> Spec:
    """A launch-scale cache leaf's spec (reference ``:146``): K/V by
    cache length over ``model`` (both axes under ``decode2d``), RWKV's
    state by its value dim, shifts, ``h`` and ``conv`` by width."""
    name = path.split("/")[-1]
    b_ax = None if mode == "decode2d" else batch_axes
    len_ax = (tuple(a for a in ("data", M) if a in mesh.axis_names)
              if mode == "decode2d" else M)
    if name in ("k", "v", "ck", "cv"):
        clen = leaf.shape[1]
        n_len = 1
        for a in (len_ax if isinstance(len_ax, tuple) else (len_ax,)):
            n_len *= mesh.shape[a]
        return (b_ax, len_ax if clen % n_len == 0 else M, None, None)
    if name == "att_state":
        return (b_ax, None, None, M)          # (B, H, hd_k, hd_v): shard v
    if name in ("att_shift", "ffn_shift", "h"):
        return (b_ax, M)                      # (B, d|w)
    if name == "conv":
        return (b_ax, None, M)                # (B, 3, w)
    return tuple(None for _ in range(len(leaf.shape)))


def cache_shardings(mesh, cfg: ModelConfig, cache, global_batch: int,
                    mode: str = "tp") -> Any:
    b_ax = _batch_spec(mesh, global_batch)
    return tree_map_with_path(
        lambda path, leaf: cache_pspec(path, leaf, mesh, b_ax, mode), cache)


# ------------------------------------------- serving-engine TP shardings
def _fit_mesh(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop spec axes absent from ``mesh`` or not dividing their dim
    (reference ``:195``)."""
    out = []
    for s, dim in zip(spec, shape):
        keep = (s is not None and s in mesh.axis_names
                and dim % mesh.shape[s] == 0)
        out.append(s if keep else None)
    return tuple(out)


def engine_param_shardings(mesh, params) -> Any:
    """The launch TP rules for a serving instance, each leaf's spec
    filtered by ``_fit_mesh`` (a 97-entry embedding stays replicated on a
    2-way mesh while wq/wk/wv/wo split; reference ``:205``)."""
    return tree_map_with_path(
        lambda path, leaf: _fit_mesh(param_pspec(path, leaf, mode="tp"),
                                     tuple(leaf.shape), mesh), params)


def engine_cache_pspec(path: str, leaf, mesh) -> Spec:
    """A serving cache leaf's spec (reference ``:215``): linear K/V, dense
    ``(B, S, KV, hd)`` and paged ``(n_blocks, bs, KV, hd)``, split by
    head like the column-split wq/wk/wv; recurrent leaves as the launch
    rules; anything not dividing replicates."""
    name = path.split("/")[-1]
    if name in ("k", "v", "ck", "cv"):
        spec = (None, None, M, None)
    elif name == "att_state":
        spec = (None, None, None, M)          # (B, H, hd_k, hd_v)
    elif name in ("att_shift", "ffn_shift", "h"):
        spec = (None, M)                      # (B, d|w)
    elif name == "conv":
        spec = (None, None, M)                # (B, 3, w)
    else:
        spec = tuple(None for _ in range(len(leaf.shape)))
    return _fit_mesh(spec, tuple(leaf.shape), mesh)


def engine_cache_shardings(mesh, cache) -> Any:
    return tree_map_with_path(
        lambda path, leaf: engine_cache_pspec(path, leaf, mesh), cache)


# ------------------------------------------------- placement and bytes
def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= mesh.shape[a]
    return n


def shard_tree(tree, specs, mesh, consume: bool = False) -> List[Any]:
    """One tree per rank of the 1-D ``("model",)`` ``mesh``: a leaf whose
    spec puts a dim on ``model`` is cut into ``tp`` equal slices along it,
    slice ``r`` a fresh tensor on ``mesh.devices[r]``; a replicated leaf
    is the leaf itself on a rank whose device it lives on, else one copy
    per distinct device. ``tree`` is nested dicts and lists, ``specs`` a
    tree of the same structure. ``consume`` sets each of ``tree``'s slots
    to None once its leaf is cut, so a leaf nothing else holds is freed
    before the next is cut: the peak is the tree plus one leaf's slices,
    not twice the tree (a full-width arctic-480b layer's experts on one
    card)."""
    if tuple(mesh.axis_names) != (M,):
        raise ValueError(f"shard_tree needs a ('model',) mesh, got "
                         f"{mesh.axis_names}")
    tp = mesh.shape[M]

    def cut(leaf, spec) -> List[Any]:
        if not isinstance(leaf, torch.Tensor):
            return [leaf] * tp
        dims = [i for i, s in enumerate(spec) if s == M]
        if not dims:
            copies = {leaf.device: leaf}
            for dev in mesh.devices:
                if dev not in copies:
                    copies[dev] = leaf.to(dev, copy=True)
            return [copies[dev] for dev in mesh.devices]
        d = dims[0]
        n = leaf.shape[d] // tp
        out = []
        for r, dev in enumerate(mesh.devices):
            part = leaf.narrow(d, r * n, n)
            out.append(torch.empty(part.shape, dtype=leaf.dtype,
                                   device=dev).copy_(part))
        return out

    def walk(node, spec) -> List[Any]:
        if not isinstance(node, (dict, list)):
            return cut(node, spec)
        keys = list(node) if isinstance(node, dict) else range(len(node))
        parts = {}
        for k in keys:
            parts[k] = walk(node[k], spec[k])
            if consume:
                node[k] = None
        if isinstance(node, dict):
            return [{k: parts[k][r] for k in keys} for r in range(tp)]
        return [[parts[k][r] for k in keys] for r in range(tp)]

    return walk(tree, specs)


def _leaf_bytes(shape, spec: Spec, mesh, itemsize: int) -> int:
    """Bytes one device holds of a leaf of ``shape`` under ``spec``: each
    split dim rounded up to a whole slice."""
    n = itemsize
    for i, dim in enumerate(shape):
        s = spec[i] if i < len(spec) else None
        k = _axis_size(mesh, s)
        n *= -(-dim // k)
    return n


def bytes_per_device(shapes, specs, mesh,
                     dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one device holds of a tree of leaves (anything with
    ``shape`` and ``dtype``) under a tree of specs of the same
    structure; ``dtype`` overrides every leaf's."""
    total = [0]

    def add(path, leaf, spec):
        dt = dtype if dtype is not None else leaf.dtype
        total[0] += _leaf_bytes(tuple(leaf.shape), spec, mesh,
                               torch.empty((), dtype=dt).element_size())

    tree_map_with_path(add, shapes, specs)
    return total[0]
