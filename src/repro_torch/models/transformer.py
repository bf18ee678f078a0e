"""Decoder trunk: the port of ``repro.models.transformer`` for every
layer kind (global ``attn``, windowed ``local_attn``, ``rglru``
(RecurrentGemma), ``rwkv`` (RWKV-6)), the MoE family (with ``n_experts``
set, every layer but an ``attn_dense`` one has a routed-expert FFN,
``models.moe``), frontend models (qwen2-vl: stub patch embeddings go
through ``frontend_proj`` and are prepended to the tokens, with M-RoPE
grid positions) and encoder-decoder models (seamless: a bidirectional
encoder over stub frame embeddings, and a cross-attention branch in
every decoder layer).

Params are a nested dict: ``embed`` (V, d), ``final_norm``, optional
``lm_head`` (d, V), ``layers``, a list with one dict per layer in
execution order (the reference stacks units for ``lax.scan``; here the
trunk is a plain loop over ``cfg.layer_kinds()``), and where the config
asks for them ``frontend_proj`` (d, d) and ``encoder`` (``layers``, a
list, and ``final_norm``). An encoder-decoder model's decoder layers also
hold ``cross_norm`` and ``cross``. A decode cache is a list with one dict
per layer: ``{"k", "v"}`` as a dense ``(B, C, KV, hd)`` slab (C =
``cache_len``, or the window for a windowed layer's ring buffer) or a
paged ``(n_blocks, bs, KV, hd)`` block pool; a recurrent layer's
per-slot state (``models.rglru``, ``models.rwkv``). An encoder-decoder
layer's dense cache also holds the static cross K/V ``ck``/``cv`` (B,
T_enc, KV, hd). Under the paged layout only linear attention layers take
the block pool (``paged_layer_kind``); windowed rings and recurrent
states stay per-slot dense beside it, and encoder-decoder models have no
paged layout, as in the reference.

Forward modes (the reference's names):
  * ``loss(params, batch)``                 — teacher-forced LM loss, the
    one mode that runs under autograd (the four full-sequence kernels
    carry their gradients, ``kernels``); ``remat`` recomputes each layer
    in the backward
  * ``prefill(params, batch)``              — logits + dense prefill cache
  * ``prefill_chunk(params, cache, batch)`` — T tokens against a cache
  * ``decode_step(params, cache, batch)``   — one token per sequence
A batch carrying ``block_tables`` addresses a paged cache, one without a
dense one (the reference's dispatch, ``transformer.py:170``, ``:210``).
Frontend and encoder-decoder prompts prefill in one shot only:
``prefill_chunk`` and ``verify_step`` refuse them, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       dense_init, embed_init, mlp_init,
                                       norm_init, unembed)
from repro_torch.models.rope import default_positions, vision_grid_positions

RECURRENT = ("rglru", "rwkv")
#: positions per cross-entropy chunk of the loss (the reference's)
LOSS_CHUNK = 256


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
                device, cross: bool = False) -> Dict:
    """One layer's params by kind, as the reference's ``_layer_init``: an
    RWKV layer is its whole block; an RG-LRU layer carries its own norm
    inside ``rec`` (no ``attn_norm``); an attention layer has
    ``attn_norm`` and ``attn`` (and, with ``cross``, an encoder-decoder
    layer's ``cross_norm`` and ``cross``). All but RWKV end in the norm
    and the FFN: the experts (``models.moe``) in an MoE layer, else an
    MLP of width ``d_ff``, or ``dense_ff or d_ff`` for ``attn_dense``."""
    if kind == "rwkv":
        return rk.rwkv_init(gen, cfg, dtype, device)
    if kind == "rglru":
        p = {"rec": rg.rglru_init(gen, cfg, dtype, device)}
    else:
        p = {"attn_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
             "attn": attn.attn_init(gen, cfg, dtype, device)}
        if cross:
            p["cross_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device)
            p["cross"] = attn.attn_init(gen, cfg, dtype, device)
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
    p["layers"] = [_layer_init(gen, cfg, kind, dtype, device, cfg.enc_dec)
                   for kind in cfg.layer_kinds()]
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                        device)
    if cfg.enc_dec:
        p["encoder"] = {
            "layers": [_layer_init(gen, cfg, "attn", dtype, device)
                       for _ in range(cfg.n_enc_layers)],
            "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device)}
    return p


# =====================================================================
# layers and trunks
# =====================================================================
def _ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
         kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual FFN sub-block: the experts in an MoE layer, else the
    MLP (the reference's ``_ffn_apply``). Returns (x, aux loss): an MoE
    layer's ``lb_loss + 1e-3 * z_loss``, which only the training loss
    reads, else 0."""
    h = apply_norm(p["ffn_norm"], x, cfg.norm)
    if _is_moe(cfg, kind):
        y, aux = moe.moe_apply(p["ffn"], h, cfg)
        return x + y, aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return x + apply_mlp(p["ffn"], h, cfg.activation), x.new_zeros(
        (), dtype=torch.float32)


def _recurrent(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
               state: Dict, decode: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """A recurrent layer from ``state``: RWKV's whole residual block, or
    the RG-LRU block plus the norm and MLP. Returns (x, aux loss, new
    state)."""
    if kind == "rwkv":
        x, new_state = rk.rwkv_block(p, x, cfg, state, decode)
        return x, x.new_zeros((), dtype=torch.float32), new_state
    h = apply_norm(p["rec"]["norm"], x, cfg.norm)
    fn = rg.rglru_decode if decode else rg.rglru_seq
    out, new_state = fn(p["rec"], h, cfg, state)
    return (*_ffn(p, x + out, cfg, kind), new_state)


def _layer_full(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                ctx: Dict) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Full-sequence layer; ``ctx`` holds ``positions``, ``mrope`` (the
    M-RoPE ids or None), ``cache`` (whether to build the prefill cache;
    the loss does not) and, for an encoder-decoder model, ``enc_out``.
    Returns (x, aux loss, the layer's prefill cache: K/V (plus the cross
    K/V ``ck``/``cv``), or the recurrent state after the sequence; ``{}``
    for an attention layer without ``cache``)."""
    if kind in RECURRENT:
        state = _layer_cache(cfg, kind, x.shape[0], 0, x.dtype, x.device)
        return _recurrent(p, x, cfg, kind, state, decode=False)
    window = _window_for(cfg, kind)
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    out, k, v = attn.attention_full(p["attn"], h, cfg, ctx["positions"],
                                    window=window,
                                    mrope_positions=ctx["mrope"])
    x = x + out
    cache = _prefill_kv(k, v, cfg, window) if ctx["cache"] else {}
    if "cross" in p:
        h = apply_norm(p["cross_norm"], x, cfg.norm)
        ck, cv = attn.cross_kv(p["cross"], ctx["enc_out"], cfg)
        x = x + attn.cross_attention(p["cross"], h, ck, cv, cfg)
        if ctx["cache"]:
            cache.update(ck=ck, cv=cv)
    return (*_ffn(p, x, cfg, kind), cache)


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
        x, _, new_state = _recurrent(p, x, cfg, kind, cache, decode)
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
    x = x + out
    if "cross" in p:  # decode only: encoder-decoder models never chunk
        h = apply_norm(p["cross_norm"], x, cfg.norm)
        x = x + attn.cross_attention(p["cross"], h, cache["ck"],
                                     cache["cv"], cfg)
    return _ffn(p, x, cfg, kind)[0]


def _trunk_full(params: Dict, x: torch.Tensor, cfg: ModelConfig, ctx: Dict,
                remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, List[Dict]]:
    """Every layer over the full sequence. Returns (x, summed aux loss,
    per-layer caches). ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` per
    unit): its activations are recomputed in the backward, so its
    kernels launch twice a step."""
    cache = []
    aux = x.new_zeros((), dtype=torch.float32)
    for p_l, kind in zip(params["layers"], cfg.layer_kinds()):
        if remat:
            x, a, c = checkpoint(_layer_full, p_l, x, cfg, kind, ctx,
                                 use_reentrant=False)
        else:
            x, a, c = _layer_full(p_l, x, cfg, kind, ctx)
        aux = aux + a
        cache.append(c)
    return x, aux, cache


def _trunk_step(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                cache: List[Dict], ctx: Dict, decode: bool) -> torch.Tensor:
    for p_l, kind, c_l in zip(params["layers"], cfg.layer_kinds(), cache):
        x = _layer_step(p_l, x, cfg, kind, c_l, ctx, decode)
    return x


def _encoder_apply(params: Dict, embeds: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The encoder over frame embeddings (B,T,d): ``frontend_proj``, then
    per layer bidirectional self-attention (RoPE on q and k, as
    ``_project_qkv`` applies it; the non-causal flash kernel) and the
    FFN, then the encoder's final norm (the reference's
    ``_encoder_apply``)."""
    x = embeds @ params["frontend_proj"]
    B, T, _ = x.shape
    positions = default_positions(B, T, device=x.device)
    for p in params["encoder"]["layers"]:
        h = apply_norm(p["attn_norm"], x, cfg.norm)
        out, _, _ = attn.attention_full(p["attn"], h, cfg, positions,
                                        causal=False)
        x = _ffn(p, x + out, cfg, "attn")[0]
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)


def _embed_inputs(params: Dict, batch: Dict, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict]:
    """The trunk's input ``x`` (B,S,d) and its ``ctx``: ``positions``
    (B,S) and ``mrope``. A frontend model's ``frontend_embeds`` (B,F,d)
    go through ``frontend_proj`` and are prepended to the tokens; under
    M-RoPE the first F positions take vision-grid (t, h, w) ids and the
    text after them the linear positions F.. . An encoder-decoder model's
    embeds run the encoder into ``enc_out`` instead (the reference's
    ``_embed_inputs`` and ``prefill``)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = apply_embed(params["embed"], tokens)
    ctx = {"mrope": None}
    if cfg.enc_dec:
        ctx["enc_out"] = _encoder_apply(params, batch["frontend_embeds"], cfg)
    elif cfg.frontend is not None:
        fe = batch["frontend_embeds"] @ params["frontend_proj"]
        x = torch.cat([fe.to(x.dtype), x], dim=1)
        F = fe.shape[1]
        if cfg.rope == "mrope":
            grid = max(1, int(F ** 0.5))
            lin = default_positions(B, x.shape[1] - F, offset=F,
                                    device=x.device)
            ctx["mrope"] = tuple(
                torch.cat([vis, lin], dim=1) for vis in
                vision_grid_positions(B, F, grid, device=x.device))
    ctx["positions"] = default_positions(B, x.shape[1], device=x.device)
    return x, ctx


def _lm_logits(params: Dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head, cfg.tie_embeddings, cfg.logit_softcap)


def _xent(params: Dict, x: torch.Tensor, labels: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy of one chunk: x (B,c,d), labels (B,c)."""
    logits = _lm_logits(params, x, cfg).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _xent_chunked(params: Dict, x: torch.Tensor, labels: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy without materialising (B,S,V): the mean over chunks
    of ``LOSS_CHUNK`` positions (one chunk when S is not a multiple) of
    each chunk's mean, as the reference's ``lax.map``. With more than one
    chunk each chunk's logits are recomputed in the backward, so autograd
    holds one chunk's at a time."""
    S = x.shape[1]
    chunk = LOSS_CHUNK if S % LOSS_CHUNK == 0 else S
    if chunk == S:
        return _xent(params, x, labels, cfg)
    losses = [checkpoint(_xent, params, x[:, i:i + chunk],
                         labels[:, i:i + chunk], cfg, use_reentrant=False)
              for i in range(0, S, chunk)]
    return torch.stack(losses).mean()


# =====================================================================
# cache construction
# =====================================================================
def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 dtype, device) -> Dict:
    """One layer's dense decode cache: a recurrent state, a ring of
    ``min(cache_len, window)`` slots, or a linear ``cache_len`` slab; an
    encoder-decoder layer adds zero cross K/V of ``enc_len(cache_len)``
    rows."""
    if kind == "rwkv":
        return rk.rwkv_state_init(cfg, batch, dtype, device)
    if kind == "rglru":
        return rg.rglru_state_init(cfg, batch, dtype, device)
    window = _window_for(cfg, kind)
    c = attn.init_kv_cache(cfg, batch, cache_len if window is None
                           else min(cache_len, window), dtype, device)
    if cfg.enc_dec:
        shp = (batch, ModelSpecs.enc_len(cache_len), cfg.n_kv_heads,
               cfg.head_dim)
        c["ck"] = torch.zeros(shp, dtype=dtype, device=device)
        c["cv"] = torch.zeros(shp, dtype=dtype, device=device)
    return c


def paged_layer_kind(cfg: ModelConfig, kind: str) -> bool:
    """True when ``kind``'s decode cache uses the block pool under a
    paged cache: linear (non-windowed) attention KV only. Recurrent
    states are O(1) per sequence and ring buffers are bounded by their
    window, so both stay per-slot dense."""
    if kind in RECURRENT or cfg.enc_dec:
        return False
    return _window_for(cfg, kind) is None


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               paged: Optional[Tuple[int, int]] = None,
               device="cuda") -> List[Dict]:
    """Decode cache for ``batch`` slots of ``cache_len`` tokens: per layer
    a dense ``(batch, cache_len, KV, hd)`` slab (a windowed layer's ring
    buffer holds ``min(cache_len, window)`` slots; a recurrent layer its
    per-slot state). ``paged=(n_blocks, block_size)`` switches the linear
    attention layers to one block pool ``(n_blocks, block_size, KV, hd)``
    each, shared by all slots; rings and recurrent states keep their
    per-slot dense layout in both modes. The reference stacks its units'
    caches for ``lax.scan``; the port keeps one entry per layer. A paged
    cache for an encoder-decoder model raises, as in the reference."""
    if paged is not None and cfg.enc_dec:
        raise NotImplementedError(
            "paged KV caches do not support encoder-decoder models")
    out = []
    for kind in cfg.layer_kinds():
        if paged is not None and paged_layer_kind(cfg, kind):
            out.append(attn.init_paged_kv_cache(cfg, *paged, dtype, device))
        else:
            out.append(_layer_cache(cfg, kind, batch, cache_len, dtype,
                                    device))
    return out


def pad_cache(cfg: ModelConfig, cache: List[Dict],
              extra: int) -> List[Dict]:
    """Extend linear (non-windowed) dense caches by ``extra`` zero slots
    so a prefill cache of S entries absorbs decode writes at
    S..S+extra-1. Ring buffers, recurrent states and the static cross
    K/V pass through."""
    out = []
    for c, kind in zip(cache, cfg.layer_kinds()):
        if kind in RECURRENT or _window_for(cfg, kind) is not None:
            out.append(c)
            continue
        out.append({key: torch.cat([t, t.new_zeros(
            (t.shape[0], extra) + tuple(t.shape[2:]))], dim=1)
            if key in ("k", "v") else t for key, t in c.items()})
    return out


# =====================================================================
# block-granular cache surgery (paged layout)
# =====================================================================
# The reference's ``_stacked`` variants address its scan-stacked unit
# caches; the port keeps a list of per-layer caches, so these two serve
# every layer.
def gather_blocks(pool: torch.Tensor, block_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Pool (N, bs, ...) and ids (n,) -> (n*bs, ...): the logical rows
    in block-table order (a copy)."""
    n, bs = block_ids.shape[0], pool.shape[1]
    return pool[block_ids.long()].reshape((n * bs,) + tuple(pool.shape[2:]))


def _rows_to_blocks(rows: torch.Tensor, n: int, bs: int) -> torch.Tensor:
    """Fold a token axis (third from last, length T <= n*bs) into (n, bs)
    blocks, zero-padding the ragged tail of the last block."""
    pad = n * bs - rows.shape[-3]
    if pad < 0:
        raise ValueError(f"{rows.shape[-3]} rows exceed {n} blocks of {bs}")
    if pad:
        rows = torch.cat([rows, rows.new_zeros(
            tuple(rows.shape[:-3]) + (pad,) + tuple(rows.shape[-2:]))],
            dim=-3)
    return rows.reshape(tuple(rows.shape[:-3]) + (n, bs)
                        + tuple(rows.shape[-2:]))


def scatter_blocks(pool: torch.Tensor, rows: torch.Tensor,
                   block_ids: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` (T, ...) with T <= n*bs into the physical blocks
    ``block_ids`` (n,) of ``pool`` (N, bs, ...), zero-padding the ragged
    tail of the last block: the block-granular primitive a prefill graft
    is built from. In place (the reference returns a new pool); returns
    ``pool``."""
    blocks = _rows_to_blocks(rows, block_ids.shape[0], pool.shape[1])
    pool.index_copy_(0, block_ids.long(), blocks.to(pool.dtype))
    return pool


# =====================================================================
# public model API
# =====================================================================
class ModelSpecs:
    """The stub frontends' sizes (the reference's ``ModelSpecs``)."""
    VLM_FRONTEND_TOKENS = 1024
    ENC_RATIO = 4  # seamless: encoder frames = seq // 4

    @staticmethod
    def enc_len(seq_len: int) -> int:
        return max(8, seq_len // ModelSpecs.ENC_RATIO)


def _plain_prompts_only(cfg: ModelConfig, what: str) -> None:
    if cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{what} supports plain token prompts only")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    #: recompute each layer's activations in the loss's backward
    remat: bool = True

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        return init_params(self.cfg, seed, dtype, device)

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Teacher-forced LM loss (the reference's ``loss``): ``batch =
        {"tokens": (B,S), "labels": (B,S)}`` plus ``"frontend_embeds"``
        for a frontend model (prepended; the F frontend positions are
        dropped before the loss) or an encoder-decoder one (the encoder's
        input). The chunked mean cross-entropy plus ``0.01 *`` the MoE
        layers' summed aux losses, as a 0-dim float32 tensor. Runs under
        autograd: the full-sequence kernels go through their
        ``torch.autograd.Function``s, so ``loss.backward()`` reaches every
        param on the card as on the CPU. Builds no decode cache."""
        cfg = self.cfg
        x, ctx = _embed_inputs(params, batch, cfg)
        x, aux, _ = _trunk_full(params, x, cfg, {**ctx, "cache": False},
                                remat=self.remat)
        if cfg.frontend is not None and not cfg.enc_dec:
            x = x[:, batch["frontend_embeds"].shape[1]:, :]
        return _xent_chunked(params, x, batch["labels"], cfg) + 0.01 * aux

    @torch.no_grad()
    def prefill(self, params: Dict, batch: Dict
                ) -> Tuple[torch.Tensor, List[Dict]]:
        """``batch = {"tokens": (B,S)}`` at positions 0..S-1, plus
        ``"frontend_embeds"`` for a frontend model ((B,F,d), prepended:
        the sequence is F + S long) or an encoder-decoder one ((B,T,d),
        the encoder's input). Returns (last-position logits (B,1,V), the
        dense prefill cache: a row per position per linear layer, a
        ``window``-slot ring per windowed layer, the state after the
        sequence per recurrent layer, and the T cross K/V rows per
        encoder-decoder layer)."""
        x, ctx = _embed_inputs(params, batch, self.cfg)
        x, _, cache = _trunk_full(params, x, self.cfg, {**ctx, "cache": True})
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
        to one processed in a single chunk. Frontend and encoder-decoder
        models raise ``NotImplementedError``, as in the reference."""
        _plain_prompts_only(self.cfg, "prefill_chunk")
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_step(params, x, self.cfg, cache, batch, decode=False)
        return _lm_logits(params, x[:, -1:, :], self.cfg), cache

    @torch.no_grad()
    def verify_step(self, params: Dict, cache: List[Dict], batch: Dict
                    ) -> Tuple[torch.Tensor, List[Dict]]:
        """Speculative verification: ``batch = {"tokens": (B,W), "pos":
        (B,)}`` plus, for a paged cache, ``"block_tables": (B,nb)``
        scores W candidate tokens per sequence, row ``j`` of sequence
        ``b`` at position ``pos[b] + j``, in one forward through the
        chunk trunk (paged layers: ``paged_prefill_attention``), and
        writes their K/V. The logits at column ``j`` are what a
        sequential ``decode_step`` of ``tokens[:, j]`` would give.
        Returns (logits at every position (B,W,V), cache), the cache
        updated in place. The caller masks or rolls back rejected rows,
        sound only where every layer can rewind
        (``serving.engine.supports_speculation``); a paged caller widens
        the table by null columns so rows past ``cache_len`` land in the
        null block. Frontend and encoder-decoder models raise
        ``NotImplementedError``, as in the reference."""
        _plain_prompts_only(self.cfg, "verify_step")
        x = apply_embed(params["embed"], batch["tokens"])
        x = _trunk_step(params, x, self.cfg, cache, batch, decode=False)
        return _lm_logits(params, x, self.cfg), cache

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
        layer's zero state (plus zero cross K/V for an encoder-decoder
        layer)."""
        return make_cache(self.cfg, batch, cache_len, dtype, device=device)

    def init_paged_cache(self, batch: int, cache_len: int, n_blocks: int,
                         block_size: int, dtype=torch.float32,
                         device="cuda") -> List[Dict]:
        """Paged decode cache: each linear attention layer's KV in a
        shared ``(n_blocks, block_size, KV, hd)`` pool
        (docs/ARCHITECTURE.md §5); rings and recurrent states per slot,
        ``batch`` rows of them."""
        return make_cache(self.cfg, batch, cache_len, dtype,
                          paged=(n_blocks, block_size), device=device)


def build_model(cfg: ModelConfig, **kw) -> Model:
    """``Model(cfg, **kw)``; ``remat`` defaults to True, as the
    reference's (serving never reads it)."""
    return Model(cfg, **kw)
