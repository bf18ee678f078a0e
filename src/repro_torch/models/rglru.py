"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU, the port of
``repro.models.rglru``.

RG-LRU (real-gated linear recurrent unit)::

    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          # input gate
    log a_t = -c * softplus(Λ) * r_t      # data-gated diagonal decay
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

wrapped in the Griffin gated block: a tanh-GELU branch multiplies the
recurrent branch, preceded by a short causal conv1d (width 4). The
sequence form runs the recurrence through ``kernels.rglru_scan`` (the
CUDA kernel on the card, its plain loop on the CPU); single-token decode
is the reference's one-step formula. A layer's state is ``{"h": (B, w)
f32, "conv": (B, 3, w)}``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import dense_init, gelu, norm_init

CONV_W = 4
DECAY_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    # Λ initialised so decay a ∈ (0.9, 0.999) at r=1 (long memory)
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(lin) / DECAY_C))
    return {
        "norm": norm_init(d, cfg.norm, dtype, device),
        "W_x": dense_init(gen, d, w, dtype, device),
        "W_gate": dense_init(gen, d, w, dtype, device),
        "conv_w": (torch.randn((CONV_W, w), generator=gen,
                               dtype=torch.float32, device=device)
                   * (1.0 / CONV_W)).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "W_a": dense_init(gen, w, w, dtype, device, scale=0.01),
        "b_a": torch.zeros((w,), dtype=dtype, device=device),
        "W_i": dense_init(gen, w, w, dtype, device, scale=0.01),
        "b_i": torch.zeros((w,), dtype=dtype, device=device),
        "lam": lam.to(dtype),
        "W_o": dense_init(gen, w, d, dtype, device),
    }


def _conv1d_causal(u: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, hist: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u (B,S,w); hist (B,CONV_W-1,w) from the
    previous segment. Returns (out (B,S,w), new_hist); new_hist is a copy,
    so a cache holding it does not keep the (B,S+3,w) buffer alive."""
    full = torch.cat([hist, u], dim=1)  # (B, S+3, w)
    out = torch.zeros_like(u)
    S = u.shape[1]
    for i in range(CONV_W):
        out = out + full[:, i:i + S, :] * conv_w[CONV_W - 1 - i][None, None]
    return out + conv_b, full[:, -(CONV_W - 1):, :].contiguous()


def _gates(p: Dict, u_in: torch.Tensor, u: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (a, gated_in) in u's dtype; the gate math runs in f32. The
    gates read ``u_in``, the whole width; the recurrence's input is ``u``,
    ``u_in`` itself unsplit or a rank's columns of it, the columns of
    ``W_a``, ``W_i``, ``b_a``, ``b_i`` and ``lam`` it holds."""
    r = torch.sigmoid((u_in @ p["W_a"] + p["b_a"]).float())
    i = torch.sigmoid((u_in @ p["W_i"] + p["b_i"]).float())
    log_a = -DECAY_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (
        i * u.float())
    return a.to(u.dtype), gated_in.to(u.dtype)


def rglru_conv(p: Dict, x: torch.Tensor, state: Dict, decode: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's input branch: ``x @ W_x`` through the causal conv. x
    (B,S,d) is the *normed* input. Returns (u, new conv history): u
    (B,S,w), or (B,w) for a decode step (S = 1). Depthwise, so a rank
    holding columns of ``W_x`` and ``conv_*`` computes its columns of
    u."""
    u = x @ p["W_x"]
    if not decode:
        return _conv1d_causal(u, p["conv_w"], p["conv_b"], state["conv"])
    full = torch.cat([state["conv"], u], dim=1)  # (B,CONV_W,w)
    u1 = torch.einsum("bcw,cw->bw", full, p["conv_w"].flip(0)) + p["conv_b"]
    return u1, full[:, 1:, :]


def rglru_mix(p: Dict, x: torch.Tensor, u_in: torch.Tensor,
              u: torch.Tensor, state: Dict, decode: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates (from ``u_in``, the whole width), the recurrence over
    ``u``'s width from ``state["h"]`` (``kernels.rglru_scan`` over a
    sequence, the one-step formula at decode), the GELU gate and ``W_o``.
    Returns (out (B,S,d), new h). A rank holding columns of the width
    (and rows of ``W_o``) returns its partial sum of out."""
    a, gated_in = _gates(p, u_in, u)
    if decode:
        h = a * state["h"].float() + gated_in
        gate = gelu(x[:, 0, :] @ p["W_gate"])
        return ((gate * h.to(x.dtype)) @ p["W_o"])[:, None, :], h.to(
            state["h"].dtype)
    hs, new_h = rglru_scan(a.float().contiguous(),
                           gated_in.float().contiguous(),
                           state["h"].float().contiguous())
    gate = gelu(x @ p["W_gate"])
    out = (gate * hs.to(x.dtype)) @ p["W_o"]
    return out, new_h.to(state["h"].dtype)


def rglru_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict
              ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Griffin recurrent block from the carried ``state``.
    x (B,S,d) is the *normed* input. Returns (out (B,S,d), new state)."""
    u, new_conv = rglru_conv(p, x, state, False)
    out, new_h = rglru_mix(p, x, u, u, state, False)
    return out, {"h": new_h, "conv": new_conv}


def rglru_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """x (B,1,d) normed input; a single recurrent step."""
    u, new_conv = rglru_conv(p, x, state, True)
    out, new_h = rglru_mix(p, x, u, u, state, True)
    return out, {"h": new_h, "conv": new_conv}


def rglru_state_init(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, w), dtype=dtype,
                                device=device)}
