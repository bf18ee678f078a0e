"""Decoder trunk: the port of ``repro.models.transformer`` for the global
``attn``, windowed ``local_attn``, ``rglru`` (RecurrentGemma) and
``rwkv`` (RWKV-6) layer kinds, and the MoE family: with ``n_experts`` set,
every layer but an ``attn_dense`` one (global attention with a dense FFN,
llama4's interleave) has a routed-expert FFN (``models.moe``).

Params are a nested dict: ``embed`` (V, d), ``final_norm``, optional
``lm_head`` (d, V), and ``layers``, a list with one dict per layer in
execution order (the reference stacks units for ``lax.scan``; here the
trunk is a plain loop over ``cfg.layer_kinds()``). A decode cache is a
list with one dict per layer: ``{"k", "v"}`` as a dense ``(B, C, KV,
hd)`` slab (C = ``cache_len``, or the window for a windowed layer's ring
buffer) or a paged ``(n_blocks, bs, KV, hd)`` block pool; a recurrent
layer's per-slot state (``models.rglru``, ``models.rwkv``). Windowed and
recurrent layers stay dense; under the paged layout they are not ported
yet (ROADMAP.md).

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
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       dense_init, embed_init, mlp_init,
                                       norm_init, unembed)

#: the layer kinds ported so far, and the recurrent ones among them
KINDS = ("attn", "attn_dense", "local_attn", "rglru", "rwkv")
RECURRENT = ("rglru", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not cover yet:
    layer kinds other than ``KINDS``, encoder-decoder and frontend models,
    and rotary variants other than ``rope`` and ``none``."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= set(KINDS):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}; only {list(KINDS)} "
            "are ported so far (ROADMAP.md, Queue A item 9)")
    if cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend models are not "
            "ported yet (ROADMAP.md, Queue A item 9)")
    if (cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.activation not in ("silu", "geglu", "gelu")
            or cfg.rope not in ("rope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: norm {cfg.norm!r}, activation {cfg.activation!r}, "
            f"rope {cfg.rope!r}; rope2d and mrope are not ported yet "
            "(ROADMAP.md, Queue A item 9)")


def check_paged_supported(cfg: ModelConfig) -> None:
    """``check_supported`` plus the paged layout's limit: every layer's
    state must live in the block pool, so recurrent layers and windowed
    layers (per-slot dense state and ring buffers beside the pool in the
    reference) raise."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    recurrent = sorted({k for k in kinds if k in RECURRENT})
    if recurrent:
        raise NotImplementedError(
            f"{cfg.name}: recurrent layers {recurrent} under the paged "
            "layout keep per-slot dense state beside the pool, not ported "
            "yet (ROADMAP.md, Queue A item 2); serve kv_layout='dense'")
    windowed = [k for k in kinds if _window_for(cfg, k)]
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
def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    """Whether a layer of ``kind`` has a routed-expert FFN (reference
    ``transformer.py:54``, ``:112``)."""
    return bool(cfg.n_experts) and kind != "attn_dense"


def _layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
                device) -> Dict:
    """One layer's params by kind, as the reference's ``_layer_init``: an
    RWKV layer is its whole block; an RG-LRU layer carries its own norm
    inside ``rec`` (no ``attn_norm``); an attention layer has
    ``attn_norm`` and ``attn``. All but RWKV end in the norm and the FFN:
    the experts (``models.moe``) in an MoE layer, else an MLP of width
    ``d_ff``, or ``dense_ff or d_ff`` for ``attn_dense``."""
    if kind == "rwkv":
        return rk.rwkv_init(gen, cfg, dtype, device)
    if kind == "rglru":
        p = {"rec": rg.rglru_init(gen, cfg, dtype, device)}
    else:
        p = {"attn_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
             "attn": attn.attn_init(gen, cfg, dtype, device)}
    p["ffn_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device)
    if _is_moe(cfg, kind):
        p["ffn"] = moe.moe_init(gen, cfg, dtype, device)
        return p
    width = (cfg.dense_ff or cfg.d_ff) if kind == "attn_dense" else cfg.d_ff
    p["ffn"] = mlp_init(gen, cfg.d_model, width,
                        cfg.activation in ("silu", "geglu"), dtype, device)
    return p


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
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                  device, scale=0.02)
    p["layers"] = [_layer_init(gen, cfg, kind, dtype, device)
                   for kind in cfg.layer_kinds()]
    return p


# =====================================================================
# layers and trunks
# =====================================================================
def _ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
         kind: str) -> torch.Tensor:
    """The residual FFN sub-block: the experts in an MoE layer (their aux
    losses feed only the reference's training loss, so they are dropped),
    else the MLP (the reference's ``_ffn_apply``)."""
    h = apply_norm(p["ffn_norm"], x, cfg.norm)
    if _is_moe(cfg, kind):
        return x + moe.moe_apply(p["ffn"], h, cfg)[0]
    return x + apply_mlp(p["ffn"], h, cfg.activation)


def _recurrent(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
               state: Dict, decode: bool) -> Tuple[torch.Tensor, Dict]:
    """A recurrent layer from ``state``: RWKV's whole residual block, or
    the RG-LRU block plus the norm and MLP. Returns (x, new state)."""
    if kind == "rwkv":
        return rk.rwkv_block(p, x, cfg, state, decode)
    h = apply_norm(p["rec"]["norm"], x, cfg.norm)
    fn = rg.rglru_decode if decode else rg.rglru_seq
    out, new_state = fn(p["rec"], h, cfg, state)
    return _ffn(p, x + out, cfg, kind), new_state


def _layer_full(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence layer; returns (x, the layer's prefill cache: K/V,
    or the recurrent state after the sequence)."""
    if kind in RECURRENT:
        state = _layer_cache(cfg, kind, x.shape[0], 0, x.dtype, x.device)
        return _recurrent(p, x, cfg, kind, state, decode=False)
    window = _window_for(cfg, kind)
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    out, k, v = attn.attention_full(p["attn"], h, cfg, positions,
                                    window=window)
    return _ffn(p, x + out, cfg, kind), _prefill_kv(k, v, cfg, window)


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


def _layer_step(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                cache: Dict, ctx: Dict, decode: bool) -> torch.Tensor:
    """A decode step (``decode``, one token) or a prefill chunk against
    the layer's cache. K/V are written into the cache in place; a
    recurrent layer runs from its state and replaces the state's tensors
    in ``cache``."""
    if kind in RECURRENT:
        x, new_state = _recurrent(p, x, cfg, kind, cache, decode)
        cache.update(new_state)
        return x
    window = _window_for(cfg, kind)
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    tables = ctx.get("block_tables")
    if tables is not None and window is None:
        fn = attn.attention_decode_paged if decode \
            else attn.attention_chunk_paged
        out = fn(p["attn"], h, cache, tables, ctx["pos"], cfg)
    else:
        fn = attn.attention_decode if decode else attn.attention_prefill_chunk
        out = fn(p["attn"], h, cache, ctx["pos"], cfg, window=window)
    return _ffn(p, x + out, cfg, kind)


def _trunk_full(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, List[Dict]]:
    cache = []
    for p_l, kind in zip(params["layers"], cfg.layer_kinds()):
        x, c = _layer_full(p_l, x, cfg, kind, positions)
        cache.append(c)
    return x, cache


def _trunk_step(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                cache: List[Dict], ctx: Dict, decode: bool) -> torch.Tensor:
    for p_l, kind, c_l in zip(params["layers"], cfg.layer_kinds(), cache):
        x = _layer_step(p_l, x, cfg, kind, c_l, ctx, decode)
    return x


def _lm_logits(params: Dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head, cfg.tie_embeddings, cfg.logit_softcap)


# =====================================================================
# cache construction
# =====================================================================
def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 dtype, device) -> Dict:
    """One layer's dense decode cache: a recurrent state, a ring of
    ``min(cache_len, window)`` slots, or a linear ``cache_len`` slab."""
    if kind == "rwkv":
        return rk.rwkv_state_init(cfg, batch, dtype, device)
    if kind == "rglru":
        return rg.rglru_state_init(cfg, batch, dtype, device)
    window = _window_for(cfg, kind)
    return attn.init_kv_cache(cfg, batch, cache_len if window is None
                              else min(cache_len, window), dtype, device)


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               paged: Optional[Tuple[int, int]] = None,
               device="cuda") -> List[Dict]:
    """Decode cache for ``batch`` slots of ``cache_len`` tokens: per layer
    a dense ``(batch, cache_len, KV, hd)`` slab (a windowed layer's ring
    buffer holds ``min(cache_len, window)`` slots; a recurrent layer its
    per-slot state), or with ``paged=(n_blocks, block_size)`` one block
    pool ``(n_blocks, block_size, KV, hd)`` shared by all slots."""
    if paged is not None:
        check_paged_supported(cfg)
        n_blocks, block_size = paged
        return [attn.init_paged_kv_cache(cfg, n_blocks, block_size, dtype,
                                         device)
                for _ in range(cfg.n_layers)]
    check_supported(cfg)
    return [_layer_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds()]


def pad_cache(cfg: ModelConfig, cache: List[Dict],
              extra: int) -> List[Dict]:
    """Extend linear (non-windowed) dense caches by ``extra`` zero slots
    so a prefill cache of S entries absorbs decode writes at
    S..S+extra-1. Ring buffers and recurrent states are fixed-size and
    pass through."""
    out = []
    for c, kind in zip(cache, cfg.layer_kinds()):
        if kind in RECURRENT or _window_for(cfg, kind) is not None:
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
        ``window``-slot ring per windowed layer, the state after S tokens
        per recurrent layer)."""
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
        written; recurrent layers run their sequence form from the
        carried state. Returns (last-position logits (B,1,V), cache), the cache
        updated in place. A prompt processed in chunks is math-identical
        to one processed in a single chunk."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_step(params, x, self.cfg, cache, batch, decode=False)
        return _lm_logits(params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def decode_step(self, params: Dict, cache: List[Dict], batch: Dict
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,1), "pos": (B,)}`` int tensors, plus
        ``"block_tables": (B,nb)`` for a paged cache; returns (logits
        (B,1,V), cache), the cache updated in place."""
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_step(params, x, self.cfg, cache, batch, decode=True)
        return _lm_logits(params, x, self.cfg), cache

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   device="cuda") -> List[Dict]:
        """Dense decode cache: per layer ``(batch, cache_len, KV, hd)``, a
        ``window``-slot ring buffer for a windowed layer, or a recurrent
        layer's zero state."""
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
