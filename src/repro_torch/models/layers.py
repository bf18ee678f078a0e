"""Shared layers: initialisers, norms, MLPs, embeddings.

Plain functions on tensors over nested-dict params, mirroring
``repro.models.layers``. Dense weights are stored ``(d_in, d_out)`` and
applied as ``x @ W`` (the reference layout, so bridged weights need no
transpose). Compute runs in the dtype of ``x``; norm statistics
accumulate in f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / d_in ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return w.to(dtype)


# ---------------------------------------------------------------- norms
def norm_init(d: int, kind: str, dtype, device) -> Dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, eps inside the sqrt, f32
    statistics. LayerNorm takes the population variance (``jnp.var``)."""
    xf = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
        out = xf / rms * p["scale"].float()
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) / torch.sqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (the exact erf
    form differs by about 1e-3, enough to change greedy tokens)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool, dtype,
             device) -> Dict:
    p = {"w_up": dense_init(gen, d, f, dtype, device),
         "w_down": dense_init(gen, f, d, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, d, f, dtype, device)
    return p


def apply_mlp(p: Dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """``"silu"``: SwiGLU; ``"geglu"``: gated tanh-GELU; ``"gelu"``: a
    plain tanh-GELU MLP (the reference's ``apply_mlp``)."""
    act = F.silu if activation == "silu" else gelu
    up = x @ p["w_up"]
    up = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    return up @ p["w_down"]


# ---------------------------------------------------------------- embed
def apply_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup. The reference's ``jnp.take`` fills out-of-range ids
    with NaN rows and wraps negative ones; here every id must lie in
    ``[0, vocab)``: ``F.embedding`` raises ``IndexError`` on the CPU and
    asserts on the card. The engine validates prompts at ``submit``."""
    return F.embedding(tokens, table)


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool,
            softcap: Optional[float] = None) -> torch.Tensor:
    """x: (..., d) -> logits (..., V). ``table_or_head`` is (V, d) if tied
    (the embedding table) else (d, V)."""
    logits = x @ table_or_head.T if tied else x @ table_or_head
    if softcap:
        logits = softcap * torch.tanh(logits.float() / softcap)
        logits = logits.to(x.dtype)
    return logits
