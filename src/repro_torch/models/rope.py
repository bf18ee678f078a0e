"""Rotary position embedding variants, the port of ``repro.models.rope``.

``rope``   — standard half-rotation RoPE (llama / starcoder2 / yi / qwen3);
``rope2d`` — chatglm-style partial rotary: RoPE over the first half of the
             head dim, the second half passes through;
``mrope``  — qwen2-vl multimodal RoPE: the rotary frequencies split into
             (temporal, height, width) sections, each rotating with its own
             position ids. Text tokens use t = h = w = the linear position,
             so ``mrope`` equals ``rope`` for pure text;
``none``   — no rotation (the attention-free rwkv configs).

Positions are explicit so decode (position = cache length) and ring
buffers share one code path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    idx = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / dim))


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim/2) in f32."""
    return positions.float()[..., None] * _inv_freq(dim, theta,
                                                    positions.device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., dim) with angles (..., dim/2); pairs are (even, odd) halves."""
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, variant: str,
               theta: float = 10_000.0,
               mrope_positions: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) absolute token positions;
    ``mrope_positions``: the (t, h, w) ids, each (B, S), for ``mrope``
    (default: all three ``positions``)."""
    if variant == "none":
        return x
    hd = x.shape[-1]
    if variant == "rope":
        return _rotate(x, _angles(positions, hd, theta)[:, :, None, :])
    if variant == "rope2d":
        half = hd // 2
        ang = _angles(positions, half, theta)[:, :, None, :]
        return torch.cat([_rotate(x[..., :half], ang), x[..., half:]], -1)
    if variant == "mrope":
        if mrope_positions is None:
            mrope_positions = (positions, positions, positions)
        # each section's angles are built over the full head dim, then the
        # first 2*sec frequencies come from t, the next sec from h, the
        # rest from w (sec = hd / 8), as in the reference
        sec = hd // 2 // 4
        a_t, a_h, a_w = (_angles(p, hd, theta) for p in mrope_positions)
        ang = torch.cat([a_t[..., :2 * sec], a_h[..., 2 * sec:3 * sec],
                         a_w[..., 3 * sec:]], -1)[:, :, None, :]
        return _rotate(x, ang)
    raise ValueError(f"unknown rope variant {variant!r}")


def default_positions(batch: int, seq: int, offset: int = 0,
                      device="cpu") -> torch.Tensor:
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos[None, :].expand(batch, seq)


def vision_grid_positions(batch: int, n_tokens: int, grid_hw: int,
                          device="cpu"
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Synthetic (t, h, w) ids, each (batch, n_tokens), for the stubbed
    vision patches laid on a ``grid_hw``-wide grid."""
    idx = torch.arange(n_tokens, dtype=torch.int32, device=device)
    t = torch.zeros_like(idx)
    h = idx // grid_hw
    w = idx % grid_hw
    return tuple(v[None, :].expand(batch, n_tokens) for v in (t, h, w))
