"""Mixture-of-Experts FFN with capacity-bucketed scatter/gather dispatch:
the port of ``repro.models.moe``.

Tokens are scattered into a dense ``(E, cap, d)`` buffer, the three expert
products (gate, up, down) run as grouped per-expert GEMMs
(``kernels.moe_matmul``: the hand-written kernel on the card, its plain
version on the CPU), and the outputs are gathered back weighted by their
gates. Entries past an expert's capacity are dropped: they contribute
nothing and the token keeps its residual path, as in GShard/Switch.

Top-1 (llama4-maverick) and top-2 with a dense residual MLP beside the
experts (arctic). The reference's sharding constraints (``shard_hooks``)
have no counterpart: they are no-ops without a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.moe_matmul import moe_matmul
from repro_torch.models.layers import apply_mlp, dense_init, mlp_init


def _expert_init(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """N(0, scale^2) weights drawn in float32 and scaled in place (a
    full-width arctic-480b weight is 17.9 GB: no second copy)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Dict:
    """The reference's distributions (``moe.py:23-39``): router std 0.02,
    w_gate / w_up ``(E, d, f)`` std ``1/sqrt(d)``, w_down ``(E, f, d)`` std
    ``1/sqrt(f)``, and arctic's gated dense MLP of width ``dense_ff or
    d_ff``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, d, E, dtype, device, scale=0.02),
         "w_gate": _expert_init(gen, (E, d, f), d ** -0.5, dtype, device),
         "w_up": _expert_init(gen, (E, d, f), d ** -0.5, dtype, device),
         "w_down": _expert_init(gen, (E, f, d), f ** -0.5, dtype, device)}
    if cfg.moe_dense_residual:
        p["dense_mlp"] = mlp_init(gen, d, cfg.dense_ff or cfg.d_ff, True,
                                  dtype, device)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` rows: ``int(cf * N * k /
    E)``, at least 8, rounded up to a multiple of 8 (``moe.py:42-44``)."""
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,d) -> (y (B,S,d), aux ``{"lb_loss", "z_loss",
    "drop_frac"}``). Capacity follows N = B * S, the rows of this call, so
    a batch's pad rows and an engine's idle slots take slots as real
    tokens do."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, d)
    logits = (xf @ p["router"]).float()                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k of the probs, descending (lax.top_k's order)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    if k > 1:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    cap = _capacity(N, cfg)
    flat_e = gate_idx.reshape(N * k)  # expert per (token, choice), token-major
    onehot = F.one_hot(flat_e, E)                              # (N*k, E)
    # an entry's slot: how many earlier entries chose the same expert
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    pos = torch.where(keep, pos, torch.zeros_like(pos))

    # scatter into (E, cap, d): a dropped entry adds a zero row at (e, 0),
    # so accumulate (a plain indexed write with repeated indices would
    # race the real token at slot 0)
    xk = xf.repeat_interleave(k, dim=0) if k > 1 else xf        # (N*k, d)
    contrib = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, pos), contrib, accumulate=True)

    # expert SwiGLU: three grouped GEMMs
    h = moe_matmul(buf, p["w_gate"])
    u = moe_matmul(buf, p["w_up"])
    h = F.silu(h) * u
    y_e = moe_matmul(h, p["w_down"])                           # (E, cap, d)

    # gather back, weight by the gates (zero for dropped entries), sum
    y_tok = y_e[flat_e, pos]                                   # (N*k, d)
    y_tok = y_tok * (gate_vals.reshape(N * k, 1)
                     * keep[:, None]).to(x.dtype)
    y = y_tok.reshape(N, k, d).sum(dim=1) if k > 1 else y_tok

    # aux: switch-style load balance over the first choice, router z-loss
    frac_tokens = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    mean_probs = probs.mean(dim=0)
    lb_loss = E * torch.sum(frac_tokens * mean_probs)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()

    if cfg.moe_dense_residual:
        y = y + apply_mlp(p["dense_mlp"], xf, cfg.activation)

    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "drop_frac": dropped}
    return y.reshape(B, S, d), aux
