"""Paged chunk-prefill attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/prefill_attention.py::paged_prefill_attention``
(Pallas, TPU). A chunk of T query rows per sequence, row i at absolute
position ``pos[b] + i``, attends the ``(N, bs, KV, hd)`` block pool
through ``block_tables (B, nb)`` under the mask ``slot <= pos[b] + i``;
the chunk's own K/V is already written through the table.

Bound on an H100: the bytes of live K/V at small T; at large T the two
products (4 * hd flops per query row and attended slot) against 67
TFLOP/s fp32 outside the tensor cores. The kernel
(``csrc/paged_prefill_attention.cu``) runs one thread block per
(sequence, KV head, tile of 16 query rows) holding the tile for all
``H / KV`` heads of the group, so each live block is read once per tile
rather than once per query head, and a tile's sweep stops at its own
last live block. Plain fp32 FMAs: tensor cores (``wgmma``), TMA and
split-K come in a later change.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG = -1.0e30


def paged_prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  pos: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """Gather the logical view through the table, then a masked softmax:
    the math of ``repro.kernels.ref.paged_prefill_attention_ref`` and of
    the reference's gather path (``attention.py:284-289``).

    Like the kernel, it never dereferences a table column past the
    chunk's last live block, nor an id outside ``[0, N)``: both read the
    null block 0 instead. Slots that no row attends contribute exactly
    zero, so they may hold anything, NaN included."""
    B, T, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    dev = q.device
    qpos = pos.long()[:, None] + torch.arange(T, device=dev)[None, :]  # (B,T)
    tbl = block_tables.long()
    live = (torch.arange(nb, device=dev)[None, :] * bs
            <= qpos[:, -1:]) & (tbl >= 0) & (tbl < N)
    tbl = torch.where(live, tbl, 0)
    k = k_pool[tbl].reshape(B, nb * bs, KV, hd).float()
    v = v_pool[tbl].reshape(B, nb * bs, KV, hd).float()
    slot = torch.arange(nb * bs, device=dev)
    mask = slot[None, None, :] <= qpos[:, :, None]                # (B,T,S)
    v = torch.where(mask.any(1)[:, :, None, None], v, 0.0)
    qg = q.reshape(B, T, KV, H // KV, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k) * scale
    scores = torch.where(mask[:, None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H, hd).to(q.dtype)


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            pos: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,T,H,hd) float32; pools (N,bs,KV,hd) float32; block_tables
    (B,nb) int32; pos (B,) int32 chunk starts -> (B,T,H,hd), row i having
    attended logical slots ``0..pos[b]+i``.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise; ``launches``
    counts the kernel launches."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool,
                                             block_tables, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    _build.check_launch_args("paged_prefill_attention", q, k_pool, v_pool,
                             block_tables, pos)
    B, T, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn = _build.load("paged_prefill_attention")
    rc = fn(q.data_ptr(), out.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), pos.data_ptr(),
            B, T, H, KV, hd, N, bs, block_tables.shape[1], float(scale),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA "
                           f"error {rc}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
