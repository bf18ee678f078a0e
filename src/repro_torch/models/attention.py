"""GQA attention: full-sequence prefill, and decode and chunked prefill
over a dense per-slot cache or a paged block pool.

The port of ``repro.models.attention``. Dense caches are linear
(``cache_len`` slots, slot = position) or ring buffers of ``window``
slots for sliding-window layers (slot = position % window; entries hold
keys already rotated at their absolute positions). The paged layout is
one physical pool of ``(n_blocks, block_size, KV, hd)`` blocks per layer
shared by every sequence and indirected through per-sequence block
tables; block 0 is the null block inactive batch rows write into.

Attention goes through the kernel wrappers (``flash_attention`` for
prefill, non-causal for an encoder and for prefill cross-attention;
``decode_attention`` and the paged kernels for decode and chunks, and
``decode_attention`` with every slot valid for decode cross-attention):
on the card the CUDA kernels, on the CPU their plain versions.
Paged decode on the card takes the split-K kernel when ``decode_splits``
asks for more than one split (B * KV up to the SM count, where splitting
was measured faster), the one-split kernel otherwise; both run one body
and compute the same function.
Chunked prefill over a dense cache has no kernel in the reference and is
plain PyTorch here too.

Unlike the reference, which rebuilt cache arrays on every write, K/V
writes update the caches IN PLACE, and their bounds are explicit: a row
past a linear cache's capacity raises (``IndexError`` on the CPU, a
device-side assertion on the card) where ``dynamic_update_slice`` would
clamp it onto earlier rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_splits, paged_decode_attention,
    paged_decode_attention_splitk, sm_count)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.prefill_attention import paged_prefill_attention
from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.models.rope import apply_rope

#: masked score of the reference's ``_sdpa`` (``attention.py:26``)
NEG_INF = -2.0e38


# ---------------------------------------------------------------- params
def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device,
                         scale=1.0 / (cfg.n_heads * hd) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dtype, device)
        p["k_norm"] = norm_init(hd, "rmsnorm", dtype, device)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, mrope_positions=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, cfg.rope, cfg.rope_theta, mrope_positions)
    k = apply_rope(k, positions, cfg.rope, cfg.rope_theta, mrope_positions)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,T,KV,hd), mask (B,Sq,T) bool -> (B,Sq,H,hd):
    the reference's masked-softmax attention (``attention.py:63-75``)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """q_pos (B,Sq), k_pos (B,T) -> (B,Sq,T) bool."""
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    return m


# ---------------------------------------------------------------- full seq
def attention_full(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, window: Optional[int] = None,
                   mrope_positions=None, causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) at positions 0..S-1 (prefill) -> (output (B,S,d), k, v).

    Causal, optionally windowed, self-attention through the flash kernel
    (``mrope_positions``: the M-RoPE (t, h, w) ids of a prefill);
    ``causal=False`` is the encoder's bidirectional attention, the
    reference's ``_sdpa`` under an all-true mask. The rotated K/V
    (B,S,KV,hd) come back too, so a prefill fills its cache from this
    projection instead of projecting a second time as the reference does
    (same math, same values)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    out = flash_attention(q, k, v, scale=scale, causal=causal, window=window)
    return out.reshape(B, S, -1) @ p["wo"], k, v


# ---------------------------------------------------------------- cross
def cross_kv(p: Dict, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V (B,T,KV,hd) of the encoder output (B,T,d):
    no RoPE, no norm (the reference's ``_cross_kv``)."""
    B, T, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_attention(p: Dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,d) attends every encoder row of k/v (B,T,KV,hd), unmasked
    and unrotated (the reference's ``_cross_core``): a prefill through
    the non-causal flash kernel, a decode step (S = 1) through
    ``decode_attention`` with every slot valid."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    if S == 1:
        valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = decode_attention(q, k, v, valid, scale)
    else:
        out = flash_attention(q, k, v, scale=scale, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------- cache
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                  device) -> Dict:
    """Dense per-slot KV layout: ``(batch, cache_len, KV, hd)`` zeros."""
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                slots: torch.Tensor) -> None:
    """cache (B,C,KV,hd); new (B,T,KV,hd); slots (B,T) -> row ``j`` of
    sequence ``b`` lands IN PLACE in slot ``slots[b, j]``. Advanced
    indexing checks each slot against C: out of range raises."""
    b = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[b, slots.long()] = new


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> None:
    """cache (B,C,KV,hd), new (B,1,KV,hd), slot (B,): one decode row per
    sequence, in place."""
    _write_rows(cache, new, slot[:, None])


def _write_chunk_linear(cache: torch.Tensor, new: torch.Tensor,
                        pos: torch.Tensor) -> None:
    """cache (B,C,KV,hd), new (B,T,KV,hd), pos (B,) -> rows pos..pos+T-1
    of each sequence overwritten with the chunk's K/V, in place."""
    T = new.shape[1]
    _write_rows(cache, new, pos.long()[:, None]
                + torch.arange(T, device=pos.device)[None, :])


def _write_chunk_ring(cache: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor) -> None:
    """Ring-buffer chunk write, in place: slot ``(pos+j) % C`` ends up
    holding the LAST chunk position that maps to it (T may exceed the
    window, in which case early chunk positions are overwritten — the
    same final state sequential decode writes would leave)."""
    B, C = cache.shape[0], cache.shape[1]
    T = new.shape[1]
    slots = torch.arange(C, device=cache.device)[None, :]        # (1, C)
    j0 = (slots - pos.long()[:, None]) % C                       # (B, C)
    j_last = j0 + ((T - 1 - j0) // C) * C                        # largest < T
    written = j0 < T
    j_safe = j_last.clamp(0, T - 1)
    idx = j_safe[:, :, None, None].expand((B, C) + tuple(new.shape[2:]))
    picked = torch.gather(new, 1, idx)                           # (B,C,KV,hd)
    cache.copy_(torch.where(written[:, :, None, None], picked, cache))


def attention_prefill_chunk(p: Dict, x: torch.Tensor, cache: Dict,
                            pos: torch.Tensor, cfg: ModelConfig, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill continuation over a dense cache: ``T`` new tokens
    ``x`` (B,T,d) at positions ``pos..pos+T-1`` against a cache filled up
    to ``pos``. Each query attends (a) what earlier chunks wrote and (b)
    the causal prefix of its own chunk: exactly the positions a
    full-sequence prefill attends. The chunk's K/V is then written
    (linear: rows pos..pos+T-1; windowed: ring slots modulo capacity) in
    place. Plain PyTorch on every device: the reference has no kernel
    for it."""
    B, T, _ = x.shape
    C = cache["k"].shape[1]
    q_pos = pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                        device=pos.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, cfg, q_pos)
    slots = torch.arange(C, dtype=pos.dtype, device=pos.device)[None, :]
    if window is not None:
        # ring: slot s holds the largest p <= pos-1 with p % C == s
        prev = pos[:, None] - 1
        k_pos_old = prev - ((prev - slots) % C)
        old_valid = k_pos_old >= 0
    else:
        k_pos_old = slots.expand(B, C)
        old_valid = slots < pos[:, None]
    old_mask = old_valid[:, None, :] & _causal_mask(q_pos, k_pos_old, window)
    chunk_mask = _causal_mask(q_pos, q_pos, window)
    k_cat = torch.cat([cache["k"], k_new], dim=1)
    v_cat = torch.cat([cache["v"], v_new], dim=1)
    mask = torch.cat([old_mask, chunk_mask], dim=2)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    out = _sdpa(q, k_cat, v_cat, mask, scale)
    write = _write_chunk_ring if window is not None else _write_chunk_linear
    write(cache["k"], k_new, pos)
    write(cache["v"], v_new, pos)
    return out.reshape(B, T, -1) @ p["wo"]


def attention_decode(p: Dict, x: torch.Tensor, cache: Dict,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """x (B,1,d); pos (B,) absolute position of the new token, written at
    slot ``pos`` (linear) or ``pos % C`` (ring) in place; the query then
    attends the valid slots through ``decode_attention``."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    slot = pos % C if window is not None else pos
    _write_cache(cache["k"], k_new, slot)
    _write_cache(cache["v"], v_new, slot)
    slots = torch.arange(C, dtype=pos.dtype, device=pos.device)[None, :]
    if window is not None:
        # ring buffer: slot s holds the largest p <= pos with p % C == s
        k_pos = pos[:, None] - ((pos[:, None] - slots) % C)
        valid = (k_pos >= 0) & (k_pos > pos[:, None] - window)
    else:
        valid = slots <= pos[:, None]
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    out = decode_attention(q, cache["k"], cache["v"], valid, scale)
    return out.reshape(B, 1, -1) @ p["wo"]


def init_paged_kv_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                        dtype, device) -> Dict:
    """Block-pool KV layout (docs/ARCHITECTURE.md §5): one physical pool
    of ``n_blocks`` blocks of ``block_size`` tokens shared by every
    sequence, indirected through per-sequence block tables. Block 0 is
    the null block (sink for inactive batch rows)."""
    shp = (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _write_paged(pool: torch.Tensor, new: torch.Tensor,
                 tables: torch.Tensor, pos: torch.Tensor) -> None:
    """pool (N,bs,KV,hd); new (B,T,KV,hd); tables (B,nb); pos (B,).

    Row ``j`` of each sequence lands IN PLACE in physical slot
    ``tables[b, (pos+j)//bs] * bs + (pos+j) % bs`` (the reference's
    ``_write_paged`` for T = 1 and ``_write_paged_chunk`` for a chunk).
    Distinct live sequences own distinct blocks, so the only colliding
    writes are inactive rows aimed at the null block, whose contents are
    never read as valid.

    Bounds are explicit: a row whose logical block lies past the table's
    width lands in the null block. The reference leaves that case to
    JAX's out-of-range gather and scatter rules; no engine schedule
    reaches it."""
    N, bs = pool.shape[0], pool.shape[1]
    B, T = new.shape[0], new.shape[1]
    nb = tables.shape[1]
    p = pos.long()[:, None] + torch.arange(T, device=pos.device)[None, :]
    col = p // bs
    blk = torch.gather(tables.long(), 1, col.clamp(max=nb - 1))
    blk = torch.where(col < nb, blk, 0)
    phys = (blk * bs + p % bs).reshape(-1)
    flat = pool.view((N * bs,) + pool.shape[2:])
    flat.index_copy_(0, phys, new.reshape((B * T,) + new.shape[2:]))


def attention_decode_paged(p: Dict, x: torch.Tensor, cache: Dict,
                           tables: torch.Tensor, pos: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
    """x (B,1,d); pos (B,) absolute position of the new token. Writes the
    new K/V through the table, then the query attends ``slots <= pos``
    (the set the dense layout attends, so greedy decode is
    token-identical across layouts)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    _write_paged(cache["k"], k_new, tables, pos)
    _write_paged(cache["v"], v_new, tables, pos)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    n_splits = 1
    if q.device.type == "cuda":
        n_splits = decode_splits(B, cache["k"].shape[2], tables.shape[1],
                                 sm_count(q.device))
    if n_splits > 1:
        out = paged_decode_attention_splitk(q, cache["k"], cache["v"],
                                            tables, pos + 1, scale,
                                            n_splits=n_splits)
    else:
        out = paged_decode_attention(q, cache["k"], cache["v"], tables,
                                     pos + 1, scale)
    return out.reshape(B, 1, -1) @ p["wo"]


def attention_chunk_paged(p: Dict, x: torch.Tensor, cache: Dict,
                          tables: torch.Tensor, pos: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Fused chunked-prefill body (docs/ARCHITECTURE.md §5): ``T`` tokens
    ``x`` (B,T,d) at positions ``pos..pos+T-1``. The chunk's K/V is
    written through the block table FIRST, then each query attends the
    pool under the causal mask ``slot <= pos+j``: the positions
    sequential decode of token ``j`` would attend."""
    B, T, _ = x.shape
    q_pos = pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                        device=pos.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, cfg, q_pos)
    _write_paged(cache["k"], k_new, tables, pos)
    _write_paged(cache["v"], v_new, tables, pos)
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    out = paged_prefill_attention(q, cache["k"], cache["v"], tables, pos,
                                  scale)
    return out.reshape(B, T, -1) @ p["wo"]
