"""Rotary position embedding.

``rope`` — standard half-rotation RoPE (llama / starcoder2 / yi / qwen3);
``none`` — no rotation (the attention-free rwkv configs). ``rope2d`` and
``mrope`` raise (ROADMAP.md, Queue A item 9).
"""
from __future__ import annotations

import torch


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim/2) in f32."""
    idx = torch.arange(0, dim, 2, dtype=torch.float32,
                       device=positions.device)
    inv = 1.0 / (theta ** (idx / dim))
    return positions.float()[..., None] * inv


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., dim) with angles (..., dim/2); pairs are (even, odd) halves."""
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, variant: str,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute token positions."""
    if variant == "none":
        return x
    if variant != "rope":
        raise NotImplementedError(
            f"rope variant {variant!r} is not ported yet (ROADMAP.md, "
            "Queue A item 9)")
    ang = _angles(positions, x.shape[-1], theta)[:, :, None, :]
    return _rotate(x, ang)
