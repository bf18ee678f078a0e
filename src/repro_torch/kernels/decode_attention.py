"""Decode attention over a dense cache and over a paged pool: the CUDA
kernels' wrappers and their plain PyTorch versions.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::
decode_attention`` (Pallas, TPU): one query token per sequence attends its
dense ``(C, KV, hd)`` cache row under a ``valid (B, C)`` mask that carries
the linear frontier, ring-buffer holes and the window; the Pallas grid
``(B, H, C / bc)`` streamed the whole cache once per query head.
``paged_decode_attention`` replaces ``repro/kernels/decode_attention.py::
paged_decode_attention``: one query token per sequence attends the
``(N, bs, KV, hd)`` block pool through ``block_tables (B, nb)``; logical
slots ``>= seq_lens[b]`` are masked and table columns past them never
read. ``paged_decode_attention_splitk`` replaces ``repro/kernels/
decode_attention.py::paged_decode_attention_splitk``: the same function
with the logical sweep cut into ``n_splits`` segments, each writing its
unnormalised ``(acc, m, l)``, merged by a second small kernel with a
log-sum-exp combine. Bound: the bytes of live K/V (4 * hd flops per 8 *
hd bytes per head pair, far below the fp32 ridge of about 20 flops per
byte).

All three kernels (``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu``, ``csrc/paged_decode_attention_splitk
.cu``) run one body (``csrc/paged_attention.cuh``), over the dense cache
or through the table: a block of eight warps per (KV head, split,
sequence) holds the group's query heads in registers (a group past 8
heads in near-equal chunks; lane ``l`` owns dims ``[4l, 4l + 4)``), deals
the split's live slots out to its warps and reads each slot's K and V row
once, as one coalesced 16-byte load per lane, several slots in flight; no
shared-memory staging and no barrier in the sweep. A dense slot marked
invalid is never read. :func:`decode_splits` picks the split count from
the batch, the KV heads, the table width and the SM count: the model's
paged decode (``models/attention.py``) takes split-K on the card whenever
it returns more than one split, and dense decode splits its cache by the
same rule over 16-slot columns (:func:`dense_split_plan`), so that
recurrentgemma-2b's MQA rows (B * KV = 8 blocks unsplit) fill the card.
Dense decode's device time on an H100 80GB HBM3 at 700 W (profiler,
``tools/attention_ab.py``): 0.0331 ms for 8 MQA rows over a wrapping
2048-slot ring (the previous kernel, one block per (KV head, sequence),
1.7807), 0.0179 over 640-slot rows (0.4919), and 0.0215 for qwen3-0.6b's
round over 544 slots (0.1515).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention import (
    NEG, _check_head_dim, paged_prefill_attention_plain)


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
                     valid: torch.Tensor, scale: float,
                     n_splits: Optional[int] = None) -> torch.Tensor:
    """q (B,1,H,hd) float32; k/v (B,C,KV,hd) float32; valid (B,C)
    torch.bool, each row with at least one valid slot -> (B,1,H,hd).

    CPU tensors take the plain version (``n_splits`` does not change the
    function). CUDA tensors launch the kernel, split as
    :func:`dense_split_plan` says (``n_splits`` overrides the rule's
    count), with the split-K combine after it where that is more than
    one split, on the current stream (no synchronisation) or raise;
    ``launches`` counts the calls that launched it."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, scale)
    if _build.abstract(q):
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    _build.check_dense_args("decode_attention", q, k, v, valid)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention: one query row per sequence, "
                         f"got q {tuple(q.shape)}")
    B, _, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    _check_head_dim("decode_attention", hd)
    out = torch.empty_like(q)
    if B == 0 or C == 0:  # no slot to attend: zeros, as the kernel writes
        return out.zero_()
    S, span = dense_split_plan(B, KV, C, sm_count(q.device), n_splits)
    part, acc, m, l = _partials(B, H, S, hd, q.device) if S > 1 \
        else (None, None, None, None)
    fn = _build.load("decode_attention")
    rc = fn(q.data_ptr(), out.data_ptr(), acc, m, l, k.data_ptr(),
            v.data_ptr(), valid.data_ptr(), B, C, H, KV, hd, S, span,
            float(scale), q.device.index,
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
    if _build.abstract(q):
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    _build.check_launch_args("paged_decode_attention", q, k_pool, v_pool,
                             block_tables, seq_lens)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: one query row per "
                         f"sequence, got q {tuple(q.shape)}")
    B, _, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    _check_head_dim("paged_decode_attention", hd)
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
    ``min(16, max(2, n_sm // (B * KV)), nb // 2)`` when ``B * KV <=
    n_sm``, else 1. A result above 1 means
    :func:`paged_decode_attention_splitk` with that ``n_splits``; 1 means
    the one-split kernel. A pure function of shapes, so choosing needs no
    host synchronisation.

    The threshold is the measured crossover (``chip_smoke.py``'s dispatch
    grid, the profiler's device time, every sequence at the full table,
    qwen3-0.6b's 8 KV heads; H100 80GB HBM3 at 700 W). Split-K, at this
    rule's count (at least 2), against one split, on 576- and 640-token
    tables: B * KV = 8: 0.0074 / 0.0086 against 0.0280 / 0.0304 ms; 64
    (the 8-slot drains): 0.0245 / 0.0256 against 0.0314 / 0.0346; 128:
    0.0339 / 0.0360 against 0.0379 / 0.0420; 256: 0.0613 / 0.0656 against
    0.0548 / 0.0625 (and 0.0211 against 0.0165 on the 8-column tables of
    ``serve_continuous`` at 32 slots). So splitting pays up to B * KV =
    128 and loses at 256, where one split's B * KV blocks already fill
    the card; ``n_sm`` (132) lies between. At 4096-token tables split-K
    wins by 3-8x at B * KV = 8 to 32 (0.0235 / 0.0370 / 0.0675 against
    0.1996 / 0.2005 / 0.2015 ms).

    End to end the choice does not show yet: the full-width qwen3-0.6b
    decode iteration is host-bound (80-89 % of it idle), and split-K's
    second launch and scratch buffer cost host time. Alternating the
    rule with one split every 5 iterations (``phase_split_rule``, 20
    pairs of turns each), split-K minus one split came to +1.07 and
    -0.44 ms per 44-50 ms iteration at 8 slots (standard errors 0.73 and
    0.54) and +1.18 and -3.03 ms at 4 slots (1.43 and 1.33): within the
    host's noise, while split-K's device busy was 0.15-0.18 ms (8 slots)
    and 0.34 ms (4 slots) lower per iteration. The rule follows device
    time, which sets the pace once the host no longer does."""
    work = B * KV
    if work < 1 or work > n_sm:
        return 1
    return max(1, min(MAX_SPLITS, max(2, n_sm // work), nb // 2))


def split_plan(nb: int, n_splits: int):
    """(splits, blocks per split) of the reference: ``n_splits`` clamped
    to ``[1, nb]``, ``bps = ceil(nb / n_splits)``, then the splits that
    would be empty dropped: ``ceil(nb / bps)``."""
    n_splits = max(1, min(n_splits, nb))
    bps = -(-nb // n_splits)
    return -(-nb // bps), bps


#: dense decode views its C cache slots as ceil(C / 16) columns of this
#: many, as paged decode's tables hold 16-slot blocks, so one split rule
#: serves both
DENSE_COLUMN = 16


def dense_split_plan(B: int, KV: int, C: int, n_sm: int,
                     n_splits: Optional[int] = None):
    """(splits, slots per split) of the card's dense decode over a
    ``C``-slot cache: :func:`decode_splits` (or ``n_splits`` where given)
    and :func:`split_plan` over ``ceil(C / DENSE_COLUMN)`` columns.
    recurrentgemma-2b's MQA rows (B * KV = 8) take 16 splits of a
    2048-slot ring (128 slots each) and 14 of a 640-slot row (48 each);
    qwen3-0.6b's 8 sequences over 8 KV heads take 2 (272 slots each of
    544); 32 slots over 8 KV heads (B * KV = 256), or a cache of at most
    16 slots, take one."""
    nb = -(-C // DENSE_COLUMN)
    S, bps = split_plan(nb, decode_splits(B, KV, nb, n_sm)
                        if n_splits is None else n_splits)
    return S, bps * DENSE_COLUMN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _partials(B: int, H: int, S: int, hd: int, device: torch.device):
    """One scratch buffer for the split kernels' partials and its
    addresses: acc (B,H,S,hd), then m and l (B,H,S) (no views: the call's
    host time is the decode step's cost). -> (buffer, acc, m, l)."""
    n_part = B * H * S
    part = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                       device=device)
    acc = part.data_ptr()
    return part, acc, acc + 4 * n_part * hd, acc + 4 * n_part * (hd + 1)


def splitk_combine_plain(acc: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor) -> torch.Tensor:
    """The reference's reduction pass over split partials acc (B,H,S,hd),
    m and l (B,H,S): rescale each split to the global max (an empty split,
    m = NEG, weighs 0), clamp the denominator at 1e-30. -> (B,1,H,hd)."""
    m_g = m.max(dim=-1, keepdim=True).values
    w = torch.exp(m - m_g)
    l_g = torch.clamp((l * w).sum(dim=-1), min=1e-30)
    return ((acc * w[..., None]).sum(dim=2) / l_g[..., None])[:, None]


def splitk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, scale: float, n_splits: int,
                 split_slots: int) -> torch.Tensor:
    """The split kernels' arithmetic in PyTorch over a logical view k/v
    (B,T,KV,hd) under valid (B,T): split ``s`` takes the slots ``[s *
    split_slots, (s + 1) * split_slots)`` (past T: none) and gives the
    unnormalised ``(acc, m, l)`` of a masked softmax (a split with no
    valid slot: m = NEG, l = 0, acc = 0); :func:`splitk_combine_plain`
    merges them. Invalid slots contribute exactly zero, so they may hold
    anything, NaN included. -> (B,1,H,hd)."""
    B, _, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    S, width = n_splits, n_splits * split_slots
    keep = valid[:, :, None, None]
    pad = torch.zeros((B, width - T, KV, hd), device=q.device)
    k = torch.cat([torch.where(keep, k.float(), 0.0), pad], 1)
    v = torch.cat([torch.where(keep, v.float(), 0.0), pad], 1)
    valid = torch.cat([valid, torch.zeros((B, width - T), dtype=torch.bool,
                                          device=q.device)], 1)
    qg = q.reshape(B, KV, H // KV, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k) * scale
    scores = torch.where(valid[:, None, None], scores, NEG)
    scores = scores.reshape(B, KV, H // KV, S, split_slots)
    m = scores.max(dim=-1).values                               # (B,KV,G,S)
    p = torch.where(valid.reshape(B, 1, 1, S, split_slots),
                    torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,bstkh->bkgsh", p,
                       v.reshape(B, S, split_slots, KV, hd))
    out = splitk_combine_plain(acc.reshape(B, H, S, hd), m.reshape(B, H, S),
                               l.reshape(B, H, S))
    return out.to(q.dtype)


def paged_decode_attention_splitk_plain(q: torch.Tensor,
                                        k_pool: torch.Tensor,
                                        v_pool: torch.Tensor,
                                        block_tables: torch.Tensor,
                                        seq_lens: torch.Tensor, scale: float,
                                        n_splits: int = 4) -> torch.Tensor:
    """The split arithmetic of the reference in PyTorch: the logical view
    gathered through the table, then :func:`splitk_plain` over
    :func:`split_plan`'s splits. Table columns past the frontier and ids
    outside ``[0, N)`` read the null block 0, and slots past ``seq_lens``
    contribute exactly zero, so they may hold anything, NaN included."""
    B = q.shape[0]
    N, bs, KV, hd = k_pool.shape
    nb = block_tables.shape[1]
    S, bps = split_plan(nb, n_splits)
    dev = q.device
    lens = seq_lens.long()[:, None]
    tbl = block_tables.long()
    live = (torch.arange(nb, device=dev)[None, :] * bs < lens) \
        & (tbl >= 0) & (tbl < N)
    tbl = torch.where(live, tbl, 0)
    valid = torch.arange(nb * bs, device=dev)[None, :] < lens   # (B, nb*bs)
    return splitk_plain(q, k_pool[tbl].reshape(B, nb * bs, KV, hd),
                        v_pool[tbl].reshape(B, nb * bs, KV, hd), valid,
                        scale, S, bps * bs)


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
    if _build.abstract(q):
        return torch.empty_like(q)
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
    _check_head_dim("paged_decode_attention_splitk", hd)
    out = torch.empty_like(q)
    if B == 0 or nb == 0:
        return out
    S, bps = split_plan(nb, n_splits)
    part, acc, m, l = _partials(B, H, S, hd, q.device)
    fn = _build.load("paged_decode_attention_splitk")
    rc = fn(q.data_ptr(), out.data_ptr(), acc, m, l, k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            B, H, KV, hd, N, bs, nb, S, bps, float(scale), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_splitk launch failed: "
                           f"CUDA error {rc}")
    paged_decode_attention_splitk.launches += 1
    return out


paged_decode_attention_splitk.launches = 0
