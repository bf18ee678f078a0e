"""npz-based tree checkpointing with structure round-trip: the port of
``repro.train.checkpoint``, in the reference's file format.

Checkpoints are written atomically (tmp + rename): one npz entry per leaf
keyed by its ``/`` path (``common.tree.flatten_with_paths``) and a
``__meta__`` entry holding the metadata as JSON bytes. Either package
reads the other's file as the same dict of arrays. ``load_checkpoint``
returns nested dicts keyed by the path parts; ``restore_like`` maps them
back onto a template's dict/list structure.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_paths, to_numpy, \
    tree_map_with_path


def save_checkpoint(path: str, tree: Any, metadata: Optional[Dict] = None
                    ) -> str:
    arrays = dict(flatten_with_paths(to_numpy(tree)))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(metadata or {}).encode(), dtype=np.uint8),
                **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Returns a nested dict keyed by the original paths, plus
    '__meta__'."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) \
            if "__meta__" in z else {}
        for key in z.files:
            if key == "__meta__":
                continue
            _insert(out, key.split("/"), z[key])
    out["__meta__"] = meta
    return out


def _insert(d: Dict, parts: List[str], value) -> None:
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def restore_like(template: Any, loaded: Dict[str, Any]) -> Any:
    """Map loaded arrays back onto the structure of ``template``: a tensor
    leaf comes back as a tensor of its dtype on its device, any other
    leaf as a numpy array of its dtype. Raises ``ValueError`` on a shape
    mismatch."""
    def restore(key, leaf):
        node: Any = loaded
        for part in key.split("/"):
            node = node[part]
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr.astype(np.asarray(leaf).dtype)

    return tree_map_with_path(restore, template)
