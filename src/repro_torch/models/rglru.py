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


def _gates(p: Dict, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (a, gated_in) in u's dtype; the gate math runs in f32."""
    r = torch.sigmoid((u @ p["W_a"] + p["b_a"]).float())
    i = torch.sigmoid((u @ p["W_i"] + p["b_i"]).float())
    log_a = -DECAY_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (
        i * u.float())
    return a.to(u.dtype), gated_in.to(u.dtype)


def rglru_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict
              ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Griffin recurrent block from the carried ``state``.
    x (B,S,d) is the *normed* input. Returns (out (B,S,d), new state)."""
    u = x @ p["W_x"]
    u, new_conv = _conv1d_causal(u, p["conv_w"], p["conv_b"], state["conv"])
    a, gated_in = _gates(p, u)
    hs, new_h = rglru_scan(a.float().contiguous(),
                           gated_in.float().contiguous(),
                           state["h"].float().contiguous())
    gate = gelu(x @ p["W_gate"])
    out = (gate * hs.to(x.dtype)) @ p["W_o"]
    return out, {"h": new_h.to(state["h"].dtype), "conv": new_conv}


def rglru_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """x (B,1,d) normed input; a single recurrent step."""
    u = x @ p["W_x"]  # (B,1,w)
    full = torch.cat([state["conv"], u], dim=1)  # (B,CONV_W,w)
    u1 = torch.einsum("bcw,cw->bw", full, p["conv_w"].flip(0)) + p["conv_b"]
    a, gated_in = _gates(p, u1)
    h = a * state["h"].float() + gated_in
    gate = gelu(x[:, 0, :] @ p["W_gate"])
    out = (gate * h.to(x.dtype)) @ p["W_o"]
    return out[:, None, :], {"h": h.to(state["h"].dtype),
                             "conv": full[:, 1:, :]}


def rglru_state_init(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, w), dtype=dtype,
                                device=device)}
