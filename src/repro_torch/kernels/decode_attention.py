"""Decode attention over a dense cache and over a paged pool: the CUDA
kernels' wrappers and their plain PyTorch versions.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::
decode_attention`` (Pallas, TPU): one query token per sequence attends its
dense ``(C, KV, hd)`` cache row under a ``valid (B, C)`` mask that carries
the linear frontier, ring-buffer holes and the window. The kernel
(``csrc/decode_attention.cu``) runs one thread block per (sequence, KV
head) holding all ``H / KV`` query heads of the group and reads K/V only
at valid slots; the Pallas grid ``(B, H, C / bc)`` streamed the whole
cache once per query head. Bound on an H100: the bytes of valid K/V.

``paged_decode_attention`` replaces ``repro/kernels/decode_attention.py::
paged_decode_attention``: one query token per sequence attends the
``(N, bs, KV, hd)`` block pool through ``block_tables (B, nb)``; logical
slots ``>= seq_lens[b]`` are masked and table columns past them never
read. Its kernel (``csrc/paged_decode_attention.cu``) has the same
(sequence, KV head) blocks and loads its own table entries for live
columns only. Bound: the bytes of live K/V (4 * hd flops per 8 * hd bytes
per head pair, far below the fp32 ridge of about 20 flops per byte).

One block per (sequence, KV head) leaves most SMs idle at small batch;
split-K over the sweep is a later change.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention import (
    NEG, paged_prefill_attention_plain)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """The masked softmax of ``repro.kernels.ref.decode_attention_ref``:
    invalid slots score NEG and weigh 0, but their values are still
    multiplied in, so they must be finite here (the kernel never reads
    them)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,1,H,hd) float32; k/v (B,C,KV,hd) float32; valid (B,C)
    torch.bool, each row with at least one valid slot -> (B,1,H,hd).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise; ``launches``
    counts the kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    _build.check_dense_args("decode_attention", q, k, v, valid)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention: one query row per sequence, "
                         f"got q {tuple(q.shape)}")
    B, _, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.load("decode_attention")
    rc = fn(q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), B, C, H, KV, hd, float(scale), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


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
    fn = _build.load("paged_decode_attention")
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
