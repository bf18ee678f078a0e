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
def norm_init(d: int, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with eps inside the sqrt and f32 statistics (the only norm
    ported so far; layernorm comes with the families that use it)."""
    xf = x.float()
    rms = torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf / rms * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, f: int, dtype, device) -> Dict:
    return {"w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device),
            "w_gate": dense_init(gen, d, f, dtype, device)}


def apply_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (the reference's ``activation="silu"`` MLP; the GELU
    variants are not ported yet)."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


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
