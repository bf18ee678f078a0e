"""Paged decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/decode_attention.py::paged_decode_attention``
(Pallas, TPU). One query token per sequence attends the ``(N, bs, KV,
hd)`` block pool through ``block_tables (B, nb)``; logical slots
``>= seq_lens[b]`` are masked and table columns past them never read.

Bound on an H100: the bytes of live K/V (4 * hd flops per 8 * hd bytes
per head pair, far below the fp32 ridge of about 20 flops per byte).
The Pallas grid ``(B, H, nb)`` streamed every block once per query
head; the kernel (``csrc/paged_decode_attention.cu``) runs one thread
block per (sequence, KV head) holding all ``H / KV`` query heads of the
group, so each live block is read once, and it loads its own table
entries for live columns only. One block per (sequence, KV head) leaves
most SMs idle at small batch; split-K over the sweep is a later change.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention import (
    paged_prefill_attention_plain)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """The gather-and-masked-softmax math of
    ``repro.kernels.ref.paged_decode_attention_ref`` and the reference's
    gather path (``attention.py:220-224``): a one-row chunk at position
    ``seq_len - 1`` attends exactly the slots ``< seq_len``."""
    return paged_prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                         seq_lens - 1, scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """q (B,1,H,hd) float32; pools (N,bs,KV,hd) float32; block_tables
    (B,nb) int32; seq_lens (B,) int32 valid logical slots, each >= 1 ->
    (B,1,H,hd).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise; ``launches``
    counts the kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    _build.check_launch_args("paged_decode_attention", q, k_pool, v_pool,
                             block_tables, seq_lens)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: one query row per "
                         f"sequence, got q {tuple(q.shape)}")
    B, _, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.load("paged_decode_attention", n_ints=7)
    rc = fn(q.data_ptr(), out.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            B, H, KV, hd, N, bs, block_tables.shape[1], float(scale),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
