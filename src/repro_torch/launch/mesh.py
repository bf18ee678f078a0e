"""Meshes: the port of ``repro.launch.mesh``.

The reference builds ``jax.sharding.Mesh``es. The port's tensor
parallelism is single-controller, as the reference's is: one Python
process drives every rank, so a mesh here is a value, an ordered tuple
of ``torch.device``s with named axes, and nothing else. An engine on a
``("model",)`` mesh places one shard of its weights and KV cache on each
rank's device and runs the ranks in lockstep
(``repro_torch.models.tp``). A device may repeat: two shards of one
instance can share one GPU (or the CPU), which is how the tests and a
one-GPU machine run tp > 1.

``make_debug_mesh`` and ``make_production_mesh`` build the dry-run's
abstract ``(data, model)`` and ``(pod, data, model)`` meshes over the
``meta`` device: shapes only, no real device needed
(``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """``devices`` in rank order (row-major over ``axis_names``) and
    ``shape``, the size of each named axis. Value-equal: two meshes over
    the same devices and axes compare equal, which is what lets
    same-degree engines share weights (``share_from``)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    def __post_init__(self):
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        if n != len(self.devices) or set(self.shape) != set(self.axis_names):
            raise ValueError(f"mesh of shape {self.shape} over "
                             f"{len(self.devices)} devices")

    def __hash__(self):
        return hash((self.devices, self.axis_names,
                     tuple(self.shape[a] for a in self.axis_names)))

    @property
    def size(self) -> int:
        return len(self.devices)


def _check_device(d) -> torch.device:
    """``d`` as a device that exists here: a CUDA index past the visible
    devices raises (nothing falls back to another device)."""
    d = torch.device(d)
    if d.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = d.index if d.index is not None else (
            torch.cuda.current_device() if n else 0)
        if index >= n:
            raise ValueError(
                f"mesh device {d} is not there: {n} CUDA device(s) visible")
        return torch.device("cuda", index)
    if d.type not in ("cpu", "meta"):
        raise ValueError(f"mesh device {d}: only cpu, cuda and meta")
    return d


def make_tp_mesh(tp_degree: int,
                 devices: Optional[Sequence] = None) -> TPMesh:
    """A 1-D ``("model",)`` mesh for one tensor-parallel serving instance.
    ``devices=None`` takes the first ``tp_degree`` visible CUDA devices and
    raises when there are fewer; an explicit list (of ``tp_degree``
    devices, repeats allowed) places rank ``r``'s shard on
    ``devices[r]``."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp_degree:
            raise ValueError(
                f"make_tp_mesh({tp_degree}) needs {tp_degree} CUDA devices "
                f"but sees only {have}. To co-locate the shards, pass "
                f"devices= that repeat one device, e.g. "
                f"make_tp_mesh({tp_degree}, devices=['cuda:0'] * "
                f"{tp_degree}) (or ['cpu'] * {tp_degree} on a host "
                "without a GPU)")
        devices = [torch.device("cuda", i) for i in range(tp_degree)]
    devices = tuple(_check_device(d) for d in devices)
    if len(devices) != tp_degree:
        raise ValueError(
            f"make_tp_mesh({tp_degree}) given {len(devices)} devices")
    return TPMesh(devices, ("model",), {"model": tp_degree})


def _abstract(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> TPMesh:
    n = 1
    for s in shape:
        n *= s
    return TPMesh((torch.device("meta"),) * n, axes, dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> TPMesh:
    """The dry-run's abstract mesh: 16x16 ``(data, model)``, or 2x16x16
    ``(pod, data, model)`` with ``multi_pod``, over ``meta``."""
    if multi_pod:
        return _abstract((2, 16, 16), ("pod", "data", "model"))
    return _abstract((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> TPMesh:
    """A small abstract ``(data, model)`` mesh over ``meta``."""
    return _abstract((n_data, n_model), ("data", "model"))


def batch_axes(mesh: TPMesh) -> tuple:
    """The axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
