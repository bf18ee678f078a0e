"""GQA attention over a paged KV cache: decode and chunked prefill.

The port of ``repro.models.attention``'s paged path. One physical pool of
``(n_blocks, block_size, KV, hd)`` blocks per layer is shared by every
sequence and indirected through per-sequence block tables; block 0 is
the null block inactive batch rows write into. Attention goes through
the kernel wrappers: on the card the CUDA kernels, on the CPU their
plain versions (the reference's gather math).

Unlike the reference, which rebuilt the pool array on every write, the
K/V writes here update the pool IN PLACE through a flat view.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import paged_decode_attention, paged_prefill_attention
from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.models.rope import apply_rope


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
        p["q_norm"] = norm_init(hd, dtype, device)
        p["k_norm"] = norm_init(hd, dtype, device)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q)
        k = apply_norm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------- cache
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
    out = paged_decode_attention(q, cache["k"], cache["v"], tables, pos + 1,
                                 scale)
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
