"""Decoder trunk: the port of ``repro.models.transformer`` for the global
``attn`` and windowed ``local_attn`` layer kinds.

Params are a nested dict: ``embed`` (V, d), ``final_norm``, optional
``lm_head`` (d, V), and ``layers``, a list with one dict per layer in
execution order (the reference stacks units for ``lax.scan``; here the
trunk is a plain loop over ``cfg.layer_kinds()``). A decode cache is a
list with one ``{"k", "v"}`` dict per layer: a dense ``(B, C, KV, hd)``
slab (C = ``cache_len``, or the window for a windowed layer's ring
buffer) or a paged ``(n_blocks, bs, KV, hd)`` block pool. Windowed
layers keep dense ring buffers; under the paged layout they are not
ported yet (ROADMAP.md), nor are the other layer kinds.

Forward modes (the reference's names):
  * ``prefill(params, batch)``              — logits + dense prefill cache
  * ``prefill_chunk(params, cache, batch)`` — T tokens against a cache
  * ``decode_step(params, cache, batch)``   — one token per sequence
A batch carrying ``block_tables`` addresses a paged cache, one without a
dense one (the reference's dispatch, ``transformer.py:170``, ``:210``).
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
    """Raise ``NotImplementedError`` for what the port does not cover yet:
    layer kinds other than ``attn`` and ``local_attn``, MoE,
    encoder-decoder and frontend models, and norms, MLPs or rotary
    variants other than RMSNorm, SwiGLU and ``rope``."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {"attn", "local_attn"}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}; only 'attn' and "
            "'local_attn' are ported so far (ROADMAP.md, Queue A)")
    if cfg.n_experts or cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE, encoder-decoder and frontend models are not "
            "ported yet (ROADMAP.md, Queue A item 9)")
    if (cfg.norm, cfg.activation, cfg.rope) != ("rmsnorm", "silu", "rope"):
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r}, activation {cfg.activation!r}, "
            f"rope {cfg.rope!r}; only rmsnorm, silu (SwiGLU) and rope are "
            "ported so far (ROADMAP.md, Queue A items 2 and 9)")


def check_paged_supported(cfg: ModelConfig) -> None:
    """``check_supported`` plus the paged layout's limit: every layer's
    KV must live in the block pool, so windowed layers (dense ring
    buffers beside the pool in the reference) raise."""
    check_supported(cfg)
    windowed = [k for k in cfg.layer_kinds() if _window_for(cfg, k)]
    if windowed:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window layers under the paged layout keep "
            "dense ring buffers beside the pool, not ported yet (ROADMAP.md, "
            "Queue A item 2); serve kv_layout='dense'")


def _window_for(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "local_attn":
        return cfg.sliding_window or 2048
    return cfg.sliding_window  # dense archs may run windowed (long_500k)


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
def _layer_full(p: Dict, x: torch.Tensor, cfg: ModelConfig, window,
                positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence layer; returns (x, the layer's prefill cache)."""
    h = apply_norm(p["attn_norm"], x)
    out, k, v = attn.attention_full(p["attn"], h, cfg, positions,
                                    window=window)
    x = x + out
    x = x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x))
    return x, _prefill_kv(k, v, cfg, window)


def _prefill_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                window: Optional[int]) -> Dict:
    """The prefill cache of one layer from its rotated K/V (B,S,KV,hd):
    linear layers keep all S rows; a windowed layer's ring buffer has
    capacity ``window`` (decode slot arithmetic is modulo it) and keeps
    the last ``window`` positions at slot ``position % window``."""
    if window is None:
        return {"k": k, "v": v}
    B, S = k.shape[0], k.shape[1]
    idx = torch.arange(S - min(window, S), S, device=k.device)
    ring = {}
    for key, t in (("k", k), ("v", v)):
        r = torch.zeros((B, window, cfg.n_kv_heads, cfg.head_dim),
                        dtype=t.dtype, device=t.device)
        r[:, idx % window] = t[:, idx]
        ring[key] = r
    return ring


def _layer_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, window,
                  cache: Dict, ctx: Dict) -> torch.Tensor:
    h = apply_norm(p["attn_norm"], x)
    tables = ctx.get("block_tables")
    if tables is not None and window is None:
        out = attn.attention_decode_paged(p["attn"], h, cache, tables,
                                          ctx["pos"], cfg)
    else:
        out = attn.attention_decode(p["attn"], h, cache, ctx["pos"], cfg,
                                    window=window)
    x = x + out
    return x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x))


def _layer_chunk(p: Dict, x: torch.Tensor, cfg: ModelConfig, window,
                 cache: Dict, ctx: Dict) -> torch.Tensor:
    h = apply_norm(p["attn_norm"], x)
    tables = ctx.get("block_tables")
    if tables is not None and window is None:
        out = attn.attention_chunk_paged(p["attn"], h, cache, tables,
                                         ctx["pos"], cfg)
    else:
        out = attn.attention_prefill_chunk(p["attn"], h, cache, ctx["pos"],
                                           cfg, window=window)
    x = x + out
    return x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x))


def _windows(cfg: ModelConfig) -> List[Optional[int]]:
    return [_window_for(cfg, k) for k in cfg.layer_kinds()]


def _trunk_full(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, List[Dict]]:
    cache = []
    for p_l, window in zip(params["layers"], _windows(cfg)):
        x, c = _layer_full(p_l, x, cfg, window, positions)
        cache.append(c)
    return x, cache


def _trunk_decode(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  cache: List[Dict], ctx: Dict) -> torch.Tensor:
    for p_l, window, c_l in zip(params["layers"], _windows(cfg), cache):
        x = _layer_decode(p_l, x, cfg, window, c_l, ctx)
    return x


def _trunk_chunk(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: List[Dict], ctx: Dict) -> torch.Tensor:
    for p_l, window, c_l in zip(params["layers"], _windows(cfg), cache):
        x = _layer_chunk(p_l, x, cfg, window, c_l, ctx)
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
    """Decode cache for ``batch`` slots of ``cache_len`` tokens: per layer
    a dense ``(batch, cache_len, KV, hd)`` slab (a windowed layer's ring
    buffer holds ``min(cache_len, window)`` slots), or with
    ``paged=(n_blocks, block_size)`` one block pool ``(n_blocks,
    block_size, KV, hd)`` shared by all slots."""
    if paged is not None:
        check_paged_supported(cfg)
        n_blocks, block_size = paged
        return [attn.init_paged_kv_cache(cfg, n_blocks, block_size, dtype,
                                         device)
                for _ in range(cfg.n_layers)]
    check_supported(cfg)
    return [attn.init_kv_cache(cfg, batch, cache_len if w is None
                               else min(cache_len, w), dtype, device)
            for w in _windows(cfg)]


def pad_cache(cfg: ModelConfig, cache: List[Dict],
              extra: int) -> List[Dict]:
    """Extend linear (non-windowed) dense caches by ``extra`` zero slots
    so a prefill cache of S entries absorbs decode writes at
    S..S+extra-1. Ring buffers are fixed-size and pass through."""
    out = []
    for c, window in zip(cache, _windows(cfg)):
        if window is not None:
            out.append(c)
            continue
        out.append({key: torch.cat([t, t.new_zeros(
            (t.shape[0], extra) + tuple(t.shape[2:]))], dim=1)
            for key, t in c.items()})
    return out


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
    def prefill(self, params: Dict, batch: Dict
                ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,S)}`` at positions 0..S-1 (plain token
        prompts; frontends are not ported). Returns (last-position logits
        (B,1,V), the dense prefill cache: S rows per linear layer, a
        ``window``-slot ring per windowed layer)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = apply_embed(params["embed"], tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        x, cache = _trunk_full(params, x, self.cfg, positions)
        return _lm_logits(params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def prefill_chunk(self, params: Dict, cache: List[Dict], batch: Dict
                      ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,T), "pos": (B,)}`` plus, for a paged
        cache, ``"block_tables": (B,nb)``: T tokens starting at absolute
        position ``pos`` against a cache filled up to ``pos``. Paged: the
        chunk's K/V is written through the table while its queries
        attend earlier blocks in place. Dense: the queries attend the
        cache and their own causal prefix, then the chunk's K/V is
        written. Returns (last-position logits (B,1,V), cache), the cache
        updated in place. A prompt processed in chunks is math-identical
        to one processed in a single chunk."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_chunk(params, x, self.cfg, cache, batch)
        return _lm_logits(params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, params: Dict, cache: List[Dict], batch: Dict
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,1), "pos": (B,)}`` int tensors, plus
        ``"block_tables": (B,nb)`` for a paged cache; returns (logits
        (B,1,V), cache), the cache updated in place."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_decode(params, x, self.cfg, cache, batch)
        return _lm_logits(params, x, self.cfg), cache

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   device="cuda") -> List[Dict]:
        """Dense decode cache: per layer ``(batch, cache_len, KV, hd)``, or
        a ``window``-slot ring buffer for a windowed layer."""
        return make_cache(self.cfg, batch, cache_len, dtype, device=device)

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
