"""The plain reference: a dense GQA decoder's full forward in float32,
with TF32 off, in plain PyTorch.

It follows the configuration file's numbers and the program's stated
arithmetic: RMSNorm with eps inside the square root and a per-feature
scale, rotary embedding over the head's first ``rot`` features as two
halves (``rot`` = the head size for ``rope``, half of it for GLM's
``rope2d``), causal attention of every query head over its KV head's
keys at scale 1/sqrt(hd), a SwiGLU MLP, a final norm and an untied head.
Weights are stored (d_in, d_out). No cache, no batching, no kernel: one
sequence at a time, attention computed a KV head at a time.

``mode`` picks the precision of every matrix product: ``fp32`` (TF32
off; the configuration's), ``tf32`` (TF32 on, on the card; on the CPU
its operands are rounded to TF32's 10-bit mantissa) or ``bf16``
(operands in bfloat16). Norms, rotary and softmax stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

MODES = ("fp32", "tf32", "bf16")


@contextlib.contextmanager
def matmul_precision(mode: str):
    """TF32 on for ``tf32`` and off otherwise, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()
    if mode == "tf32" and a.device.type != "cuda":
        return torch.matmul(round_tf32(a), round_tf32(b))
    return torch.matmul(a, b)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rotary(x: torch.Tensor, pos: torch.Tensor, rot: int,
            theta: float) -> torch.Tensor:
    """x (S, heads, hd): the first ``rot`` features rotated as two halves
    by angle pos * theta^(-2i/rot); the rest pass through."""
    half = rot // 2
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:rot]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, x[..., rot:]],
                     dim=-1)


def _attention(q, k, v, mode: str) -> torch.Tensor:
    """Causal GQA: q (S, H, hd), k/v (S, KV, hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(S, H, hd, dtype=torch.float32, device=q.device)
    for g in range(KV):
        qg = q[:, g * G:(g + 1) * G, :].transpose(0, 1)        # (G, S, hd)
        kg = k[:, g, :]                                           # (S, hd)
        scores = _mm(qg, kg.T, mode) / math.sqrt(hd)              # (G, S, S)
        probs = torch.softmax(scores.masked_fill(~mask, -math.inf), -1)
        out[:, g * G:(g + 1) * G, :] = _mm(probs, v[:, g, :],
                                           mode).transpose(0, 1)
    return out.reshape(S, H * hd)


def rotary_width(cfg: Dict) -> int:
    if cfg["rope"] == "rope":
        return cfg["head_dim"]
    if cfg["rope"] == "rope2d":
        return cfg["head_dim"] // 2
    raise ValueError(f"no reference for rope {cfg['rope']!r}")


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, first: int,
           mode: str = "fp32") -> torch.Tensor:
    """The logits (S - first, V) at positions first..S-1 of the sequence
    ``tokens`` (S,) at positions 0..S-1."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if cfg["activation"] != "silu" or cfg["norm"] != "rmsnorm" \
            or cfg.get("tie_embeddings"):
        raise ValueError("the reference serves gated-SiLU, RMSNorm, untied "
                         "decoders only")
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta, rot = cfg["norm_eps"], cfg["rope_theta"], rotary_width(cfg)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    with matmul_precision(mode):
        x = params["embed"][tokens.long()].float()
        for p in params["layers"]:
            a = p["attn"]
            h = _rmsnorm(x, p["attn_norm"]["scale"], eps)
            q = _rotary(_mm(h, a["wq"], mode).view(S, H, hd), pos, rot,
                        theta)
            k = _rotary(_mm(h, a["wk"], mode).view(S, KV, hd), pos, rot,
                        theta)
            v = _mm(h, a["wv"], mode).view(S, KV, hd)
            x = x + _mm(_attention(q, k, v, mode), a["wo"], mode)
            f = p["ffn"]
            h = _rmsnorm(x, p["ffn_norm"]["scale"], eps)
            up = _mm(h, f["w_up"], mode)
            gate = torch.nn.functional.silu(_mm(h, f["w_gate"], mode))
            x = x + _mm(gate * up, f["w_down"], mode)
        x = _rmsnorm(x[first:], params["final_norm"]["scale"], eps)
        return _mm(x, params["lm_head"], mode)
