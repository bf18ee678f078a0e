"""The collectives of the rank-split forward (``repro_torch.models.tp``):
the port's counterpart of ``repro.models.shard_hooks``.

The reference's hook is ``constrain``, a ``with_sharding_constraint``
that tells GSPMD how to lay an activation out; XLA then inserts the
collectives. Eager PyTorch has no compiler to read a constraint, so the
port has no ``constrain`` (nor its ``REPRO_NO_CONSTRAIN`` switch): the
rank-split forward runs each rank's shard itself and calls the
collectives below where the reference's partitioner would put them.

One process drives every rank (single-controller, as the reference's
``jit`` over a mesh), so a collective is a function of the ranks'
partials, a list in rank order, each on its rank's device. Both are
written for a fixed result, not for speed: the sum is taken in rank order
on rank 0's device, the order the CPU tests pin, which neither NCCL nor
``torch.cuda.comm`` promises.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one per rank), added in rank order on rank
    0's device, then one copy per rank on that rank's device (the same
    tensor where a rank shares rank 0's device)."""
    dev0 = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev0)
    return [total.to(p.device) for p in parts]


def all_gather(parts: Sequence[torch.Tensor], dim: int
               ) -> List[torch.Tensor]:
    """``parts`` concatenated in rank order along ``dim`` on rank 0's
    device, then one copy per rank on that rank's device."""
    dev0 = parts[0].device
    full = torch.cat([p.to(dev0) for p in parts], dim=dim)
    return [full.to(p.device) for p in parts]
