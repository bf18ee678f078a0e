"""The device policy every entry point of the port shares."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) needs a GPU and raises without one: nothing carries on
    on the CPU unless the caller asked for it with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU "
            "unless the caller passes device='cpu' (the CPU runs the "
            "kernels' plain PyTorch versions)")
    return device


def to_device(tree, device):
    """A nested dict/list of tensors moved to ``device``; other leaves
    (an edge net's int strides) pass through."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
