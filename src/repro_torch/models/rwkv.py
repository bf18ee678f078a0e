"""RWKV-6 ("Finch") block: data-dependent-decay linear attention, the port
of ``repro.models.rwkv``.

Per head with key/value dim ``hd``::

    out_t  = r_t^T (state_t + diag(u) k_t v_t^T)
    state_{t+1} = diag(w_t) state_t + k_t v_t^T

where the decay ``w_t`` and the token-shift interpolation weights are
data-dependent through low-rank adapters. The sequence form runs the
recurrence through ``kernels.rwkv6_scan`` (the CUDA kernel on the card,
its plain loop on the CPU); single-token decode is the reference's
one-step formula. The head count is ``d_model // rwkv_head_size``, not
``cfg.n_heads``. A layer's state is ``{"att_state": (B, H, hd, hd) f32,
"att_shift": (B, d), "ffn_shift": (B, d)}``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, wkv_step
from repro_torch.models.layers import apply_norm, dense_init, norm_init

LORA_DIM = 32
MIX_NAMES = ("r", "k", "v", "w", "g")


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size
    return cfg.d_model // hd, hd


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              device) -> Dict:
    d = cfg.d_model
    H, hd = _heads(cfg)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    tm: Dict = {"norm": norm_init(d, cfg.norm, dtype, device),
                "mu_x": zeros(d)}
    for nm in MIX_NAMES:
        tm[f"mu_{nm}"] = zeros(d)
        tm[f"A_{nm}"] = dense_init(gen, d, LORA_DIM, dtype, device,
                                   scale=0.01)
        tm[f"B_{nm}"] = dense_init(gen, LORA_DIM, d, dtype, device,
                                   scale=0.01)
    for nm in ("r", "k", "v", "g", "o"):
        tm[f"W_{nm}"] = dense_init(gen, d, d, dtype, device)
    # decay base: w = exp(-exp(.)) spans (0, 1) across channels
    tm["w_base"] = torch.linspace(-6.0, 1.0, d, dtype=torch.float32,
                                  device=device).to(dtype)
    tm["u"] = (torch.randn((H, hd), generator=gen, dtype=torch.float32,
                           device=device) * 0.1).to(dtype)
    tm["ln_x"] = norm_init(hd, "rmsnorm", dtype, device)  # per head

    cm: Dict = {"norm": norm_init(d, cfg.norm, dtype, device),
                "mu_k": zeros(d), "mu_r": zeros(d),
                "W_k": dense_init(gen, d, cfg.d_ff, dtype, device),
                "W_v": dense_init(gen, cfg.d_ff, d, dtype, device),
                "W_r": dense_init(gen, d, d, dtype, device)}
    return {"time_mix": tm, "channel_mix": cm}


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x (B,S,d), last (B,d) = final token of the previous segment."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(tm: Dict, x: torch.Tensor, xx: torch.Tensor,
            nm: str) -> torch.Tensor:
    """RWKV-6 data-dependent lerp between x and shifted x."""
    base = x + xx * tm["mu_x"]
    lora = torch.tanh(base @ tm[f"A_{nm}"]) @ tm[f"B_{nm}"]
    return x + xx * (tm[f"mu_{nm}"] + lora)


def _rkvwg(tm: Dict, x: torch.Tensor, shifted: torch.Tensor, H: int,
           hd: int):
    xx = shifted - x
    r = _ddlerp(tm, x, xx, "r") @ tm["W_r"]
    k = _ddlerp(tm, x, xx, "k") @ tm["W_k"]
    v = _ddlerp(tm, x, xx, "v") @ tm["W_v"]
    g = F.silu(_ddlerp(tm, x, xx, "g") @ tm["W_g"])
    w_in = _ddlerp(tm, x, xx, "w")
    log_w = tm["w_base"].float() + (
        torch.tanh(w_in @ tm["A_w"]) @ tm["B_w"]).float()
    w = torch.exp(-torch.exp(log_w))  # (…, d) in (0,1)
    shp = tuple(x.shape[:-1]) + (H, hd)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp),
            g)


def time_mix_seq(tm: Dict, x: torch.Tensor, cfg: ModelConfig,
                 state: torch.Tensor, shift: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix. x (B,S,d); state (B,H,hd,hd); shift (B,d).
    Returns (out (B,S,d), new_state, new_shift)."""
    B, S, d = x.shape
    H, hd = _heads(cfg)
    r, k, v, w, g = _rkvwg(tm, x, _token_shift(x, shift), H, hd)
    out, new_state = rwkv6_scan(
        *(t.float().contiguous() for t in (r, k, v, w)),
        tm["u"].float().contiguous(), state.float().contiguous())
    out = apply_norm(tm["ln_x"], out.to(x.dtype), "rmsnorm")
    out = (out.reshape(B, S, d) * g) @ tm["W_o"]
    return out, new_state.to(state.dtype), x[:, -1, :].contiguous()


def time_mix_decode(tm: Dict, x: torch.Tensor, cfg: ModelConfig,
                    state: torch.Tensor, shift: torch.Tensor):
    """Single-token decode. x (B,1,d)."""
    B, _, d = x.shape
    H, hd = _heads(cfg)
    xt = x[:, 0, :]
    r, k, v, w, g = _rkvwg(tm, xt, shift, H, hd)
    new_state, out = wkv_step(state.float(), r.float(), k.float(),
                              v.float(), w.float(), tm["u"].float())
    out = apply_norm(tm["ln_x"], out[:, :, None, :].transpose(1, 2)
                     .to(x.dtype), "rmsnorm")  # (B,1,H,hd)
    out = (out.reshape(B, 1, d) * g[:, None, :]) @ tm["W_o"]
    return out, new_state.to(state.dtype), xt


def channel_mix(cm: Dict, x: torch.Tensor, shift: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) (S may be 1); returns (out, new_shift)."""
    xx = _token_shift(x, shift) - x
    xk = x + xx * cm["mu_k"]
    xr = x + xx * cm["mu_r"]
    k = torch.square(torch.relu(xk @ cm["W_k"]))
    out = torch.sigmoid(xr @ cm["W_r"]) * (k @ cm["W_v"])
    return out, x[:, -1, :].contiguous()


def rwkv_state_init(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    d = cfg.d_model
    H, hd = _heads(cfg)
    return {
        "att_state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                 device=device),
        "att_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "ffn_shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Dict,
               decode: bool) -> Tuple[torch.Tensor, Dict]:
    """Residual RWKV block (time-mix, then channel-mix), each behind a
    ``cfg.norm`` norm. Returns (x, new state)."""
    h = apply_norm(p["time_mix"]["norm"], x, cfg.norm)
    fn = time_mix_decode if decode else time_mix_seq
    att, new_att_state, new_att_shift = fn(
        p["time_mix"], h, cfg, state["att_state"], state["att_shift"])
    x = x + att
    h = apply_norm(p["channel_mix"]["norm"], x, cfg.norm)
    ffn, new_ffn_shift = channel_mix(p["channel_mix"], h, state["ffn_shift"])
    return x + ffn, {"att_state": new_att_state,
                     "att_shift": new_att_shift,
                     "ffn_shift": new_ffn_shift}
