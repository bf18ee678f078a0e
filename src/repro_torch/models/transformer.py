"""Decoder trunk over a paged KV cache: the port of
``repro.models.transformer`` for the ``attn`` layer kind.

Params are a nested dict: ``embed`` (V, d), ``final_norm``, optional
``lm_head`` (d, V), and ``layers``, a list with one dict per layer in
execution order (the reference stacks units for ``lax.scan``; here the
trunk is a plain loop). The decode cache is a list with one
``{"k", "v"}`` block pool per layer. Any layer kind other than global
``attn`` raises; the other kinds and the dense cache layout are listed in
ROADMAP.md.

Forward modes (the reference's names):
  * ``prefill_chunk(params, cache, batch)`` — T tokens against the pool
  * ``decode_step(params, cache, batch)``   — one token per sequence
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       dense_init, embed_init, mlp_init,
                                       norm_init, unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port:
    layer kinds other than global ``attn``, sliding windows, MoE,
    encoder-decoder and frontend models, and norms, MLPs or rotary
    variants other than RMSNorm, SwiGLU and ``rope``."""
    kinds = set(cfg.layer_kinds())
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}; only global 'attn' "
            "is ported so far (ROADMAP.md, Queue A)")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention keeps a dense ring "
            "cache, not ported yet (ROADMAP.md, Queue A)")
    if cfg.n_experts or cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE, encoder-decoder and frontend models are not "
            "ported yet (ROADMAP.md, Queue A item 9)")
    if (cfg.norm, cfg.activation, cfg.rope) != ("rmsnorm", "silu", "rope"):
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r}, activation {cfg.activation!r}, "
            f"rope {cfg.rope!r}; only rmsnorm, silu (SwiGLU) and rope are "
            "ported so far (ROADMAP.md, Queue A items 2 and 9)")


# =====================================================================
# parameter construction
# =====================================================================
def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Dict:
    return {
        "attn_norm": norm_init(cfg.d_model, dtype, device),
        "attn": attn.attn_init(gen, cfg, dtype, device),
        "ffn_norm": norm_init(cfg.d_model, dtype, device),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict:
    """Random params with the reference's distributions
    (``layers.py:16-22``), drawn from a seeded ``torch.Generator`` on
    ``device``. The values differ from ``jax.random``'s; parity tests
    bridge the reference's weights instead (``models.bridge``)."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": norm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  device, scale=0.02)
    p["layers"] = [_layer_init(gen, cfg, dtype, device)
                   for _ in range(cfg.n_layers)]
    return p


# =====================================================================
# layers and trunks
# =====================================================================
def _layer_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict,
                  ctx: Dict) -> torch.Tensor:
    h = apply_norm(p["attn_norm"], x)
    x = x + attn.attention_decode_paged(p["attn"], h, cache,
                                        ctx["block_tables"], ctx["pos"], cfg)
    return x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x))


def _layer_chunk(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict,
                 ctx: Dict) -> torch.Tensor:
    h = apply_norm(p["attn_norm"], x)
    x = x + attn.attention_chunk_paged(p["attn"], h, cache,
                                       ctx["block_tables"], ctx["pos"], cfg)
    return x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x))


def _trunk_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  cache: List[Dict], ctx: Dict) -> torch.Tensor:
    for p_l, c_l in zip(params["layers"], cache):
        x = _layer_decode(p_l, x, cfg, c_l, ctx)
    return x


def _trunk_chunk(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: List[Dict], ctx: Dict) -> torch.Tensor:
    for p_l, c_l in zip(params["layers"], cache):
        x = _layer_chunk(p_l, x, cfg, c_l, ctx)
    return x


def _lm_logits(params: Dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head, cfg.tie_embeddings, cfg.logit_softcap)


# =====================================================================
# cache construction
# =====================================================================
def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               paged: Optional[Tuple[int, int]] = None,
               device="cuda") -> List[Dict]:
    """Decode cache: with ``paged=(n_blocks, block_size)`` one block pool
    ``(n_blocks, block_size, KV, hd)`` per layer, shared by all slots
    (``batch`` and ``cache_len`` size only the dense layout, which is not
    ported yet)."""
    check_supported(cfg)
    if paged is None:
        raise NotImplementedError(
            "the dense per-slot KV layout is not ported yet (ROADMAP.md, "
            "Queue A item 3); use paged=(n_blocks, block_size)")
    n_blocks, block_size = paged
    return [attn.init_paged_kv_cache(cfg, n_blocks, block_size, dtype,
                                     device)
            for _ in range(cfg.n_layers)]


# =====================================================================
# public model API
# =====================================================================
@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        check_supported(self.cfg)

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        return init_params(self.cfg, seed, dtype, device)

    @torch.no_grad()
    def prefill_chunk(self, params: Dict, cache: List[Dict], batch: Dict
                      ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,T), "pos": (B,), "block_tables":
        (B,nb)}``: T tokens starting at absolute position ``pos``, written
        into the paged pool through the table while their queries attend
        earlier blocks in place. Returns (last-position logits (B,1,V),
        cache); the pools are updated in place. A prompt processed in
        chunks is math-identical to one processed in a single chunk."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_chunk(params, x, self.cfg, cache, batch)
        return _lm_logits(params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, params: Dict, cache: List[Dict], batch: Dict
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,1), "pos": (B,), "block_tables":
        (B,nb)}`` int tensors; returns (logits (B,1,V), cache), the pools
        updated in place."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_decode(params, x, self.cfg, cache, batch)
        return _lm_logits(params, x, self.cfg), cache

    def init_paged_cache(self, batch: int, cache_len: int, n_blocks: int,
                         block_size: int, dtype=torch.float32,
                         device="cuda") -> List[Dict]:
        """Paged decode cache: each layer's KV in a shared
        ``(n_blocks, block_size, KV, hd)`` pool (docs/ARCHITECTURE.md
        §5)."""
        return make_cache(self.cfg, batch, cache_len, dtype,
                          paged=(n_blocks, block_size), device=device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
