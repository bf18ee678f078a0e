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

``paged_decode_attention_splitk`` replaces ``repro/kernels/
decode_attention.py::paged_decode_attention_splitk``: the same function
with the logical sweep cut into ``n_splits`` segments. Its kernel
(``csrc/paged_decode_attention_splitk.cu``) runs one block per (KV head,
split, sequence), each writing its split's unnormalised ``(acc, m, l)``,
and a second small kernel merges them with a log-sum-exp combine.

One block per (sequence, KV head) leaves most of the 132 SMs idle when
B * KV is small: 32 blocks for qwen3-0.6b's 8 KV heads at the pool's
four slots. :func:`decode_splits` picks the split count from the batch,
the KV heads, the table width and the SM count, and the model's paged
decode (``models/attention.py``) takes split-K on the card whenever it
returns more than one split.
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


#: the dispatch splits into at most this many segments
MAX_SPLITS = 16


def decode_splits(B: int, KV: int, nb: int, n_sm: int) -> int:
    """The split count the card's paged decode takes for a batch of ``B``
    sequences over ``KV`` heads and ``nb``-column tables on ``n_sm`` SMs:
    ``min(16, n_sm // (B * KV), nb // 2)`` when ``B * KV <= n_sm // 4``,
    else 1. A result above 1 means :func:`paged_decode_attention_splitk`
    with that ``n_splits``; 1 means the unsplit kernel. A pure function of
    shapes, so choosing needs no host synchronisation.

    The threshold is not where splitting stops paying. On an H100 80GB
    HBM3 at 700 W, split-K on 640-token tables takes 0.084-0.121 ms of
    device time against the unsplit kernel's 0.242-0.244 ms at every
    B * KV timed from 40 to 128 (2 or 3 splits; ``chip_smoke.py``). The
    quarter of the SMs is held so that the 8-slot engines (B * KV = 64)
    keep launching the unsplit kernel: both kernels stay on a path until
    the paged decode's redesign moves the threshold or retires one."""
    work = B * KV
    if work < 1 or work > n_sm // 4:
        return 1
    return max(1, min(MAX_SPLITS, n_sm // work, nb // 2))


def split_plan(nb: int, n_splits: int):
    """(splits, blocks per split) of the reference: ``n_splits`` clamped
    to ``[1, nb]``, ``bps = ceil(nb / n_splits)``, then the splits that
    would be empty dropped: ``ceil(nb / bps)``."""
    n_splits = max(1, min(n_splits, nb))
    bps = -(-nb // n_splits)
    return -(-nb // bps), bps


def splitk_combine_plain(acc: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor) -> torch.Tensor:
    """The reference's reduction pass over split partials acc (B,H,S,hd),
    m and l (B,H,S): rescale each split to the global max (an empty split,
    m = NEG, weighs 0), clamp the denominator at 1e-30. -> (B,1,H,hd)."""
    m_g = m.max(dim=-1, keepdim=True).values
    w = torch.exp(m - m_g)
    l_g = torch.clamp((l * w).sum(dim=-1), min=1e-30)
    return ((acc * w[..., None]).sum(dim=2) / l_g[..., None])[:, None]


def paged_decode_attention_splitk_plain(q: torch.Tensor,
                                        k_pool: torch.Tensor,
                                        v_pool: torch.Tensor,
                                        block_tables: torch.Tensor,
                                        seq_lens: torch.Tensor, scale: float,
                                        n_splits: int = 4) -> torch.Tensor:
    """The split arithmetic of the reference in PyTorch: per split, the
    unnormalised ``(acc, m, l)`` of a masked softmax over its logical
    blocks (an empty split gives m = NEG, l = 0, acc = 0), then
    :func:`splitk_combine_plain`. Table columns past the frontier and ids
    outside ``[0, N)`` read the null block 0, and slots past
    ``seq_lens`` contribute exactly zero, so they may hold anything, NaN
    included."""
    B, _, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    S, bps = split_plan(nb, n_splits)
    dev = q.device
    lens = seq_lens.long()[:, None]
    tbl = block_tables.long()
    live = (torch.arange(nb, device=dev)[None, :] * bs < lens) \
        & (tbl >= 0) & (tbl < N)
    tbl = torch.where(live, tbl, 0)
    # the last split's blocks past nb are padded in, empty
    width = S * bps * bs
    valid = torch.arange(width, device=dev)[None, :] \
        < torch.clamp(lens, max=nb * bs)                        # (B, width)
    pad = torch.zeros((B, (S * bps - nb) * bs, KV, hd), device=dev)
    k = torch.cat([k_pool[tbl].reshape(B, nb * bs, KV, hd).float(), pad], 1)
    v = torch.cat([v_pool[tbl].reshape(B, nb * bs, KV, hd).float(), pad], 1)
    keep = valid[:, :, None, None]
    k = torch.where(keep, k, 0.0)
    v = torch.where(keep, v, 0.0)
    qg = q.reshape(B, KV, H // KV, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k) * scale
    scores = torch.where(valid[:, None, None], scores, NEG)
    scores = scores.reshape(B, KV, H // KV, S, bps * bs)
    m = scores.max(dim=-1).values                               # (B,KV,G,S)
    p = torch.where(valid.reshape(B, 1, 1, S, bps * bs),
                    torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,bstkh->bkgsh", p,
                       v.reshape(B, S, bps * bs, KV, hd))
    out = splitk_combine_plain(acc.reshape(B, H, S, hd), m.reshape(B, H, S),
                               l.reshape(B, H, S))
    return out.to(q.dtype)


def paged_decode_attention_splitk(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  seq_lens: torch.Tensor, scale: float,
                                  n_splits: int = 4) -> torch.Tensor:
    """:func:`paged_decode_attention` with the logical sweep in
    ``n_splits`` segments (the reference's ``ops.py:54`` signature;
    ``split_plan`` fixes the actual count) -> (B,1,H,hd).

    CPU tensors take the plain version. CUDA tensors launch the split
    kernel and its combine kernel on the current stream (no
    synchronisation) or raise; ``launches`` counts the calls that
    launched the pair."""
    if q.device.type == "cpu":
        return paged_decode_attention_splitk_plain(
            q, k_pool, v_pool, block_tables, seq_lens, scale, n_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_splitk: no kernel for "
                         f"{q.device}")
    _build.check_launch_args("paged_decode_attention_splitk", q, k_pool,
                             v_pool, block_tables, seq_lens)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention_splitk: one query row per "
                         f"sequence, got q {tuple(q.shape)}")
    B, _, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or nb == 0:
        return out
    S, bps = split_plan(nb, n_splits)
    # one scratch buffer: acc (B,H,S,hd), then m and l (B,H,S)
    part = torch.empty(B * H * S * (hd + 2), dtype=torch.float32,
                       device=q.device)
    acc, m, l = part.split([B * H * S * hd, B * H * S, B * H * S])
    fn = _build.load("paged_decode_attention_splitk")
    rc = fn(q.data_ptr(), out.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), B, H, KV, hd, N,
            bs, nb, S, bps, float(scale), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_splitk launch failed: "
                           f"CUDA error {rc}")
    paged_decode_attention_splitk.launches += 1
    return out


paged_decode_attention_splitk.launches = 0
