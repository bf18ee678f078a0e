#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the eight hand-written kernels (five attention kernels, split-K
paged decode among them, the RG-LRU and the RWKV-6 scans, the grouped
expert GEMM) from the sources in this checkout, holds each against its
plain PyTorch version at the main paths' shapes on poisoned inputs (the
five attention kernels, which run two bodies, at GQA groups of 2, 5 and 7
and at MQA; split-K also against one split), times them (paged decode
over the B x KV grid behind its dispatch), serves full-width qwen3-0.6b through each main path (the paged
continuous engine, ``serve_continuous`` at 4 and 32 slots, round mode with
the SAC scheduler, the dense continuous engine), then through the multi-model
instance pool under the PoolScheduler (``serve_pool``: qwen3-0.6b paged,
whose four-slot instances decode through split-K, and qwen3-0.6b with
recurrentgemma-2b dense), full-width recurrentgemma-2b and rwkv6-3b
through the dense continuous engine and round mode, and arctic-480b at
full width cut to one layer through the paged continuous engine and round
mode, with exact kernel launch counts, and checks the card's greedy tokens
against the CPU's on every path at reduced width (the pool's too; the MoE
family also with capacity drops). The online path runs at full-width
qwen3-0.6b too: recompute preemption in the paged engine (two evictions
in the drains' requests; every stream against the uninterrupted run, and
the device cost of one resume's re-prefill) and in the pool
(``preemption=True``, two SLO tiers 4x apart), push-mode HTTP serving
(``ServingDriver`` and ``ServingFrontend`` on port 0 in this process:
streams against the offline pool, a disconnect cancelled and its KV
freed, 429 with Retry-After, TTFT and TPOT on the host clock), seeded
sampling in round mode, and the prefix cache (``phase_prefix``: the
drains' requests templated on two 500-token prefixes with the cache off
and on, a fully covering repeat whose copy-on-write leaves the shared
blocks' bytes alone, ``serve_continuous`` over a template, and the
paged pool of qwen3-0.6b with recurrentgemma-2b, whose rings and states
sit beside the pool), speculative decoding (``phase_spec``: the drains'
engine paged and dense built for k = 4, its depth toggled 4, 2, 0, 4
mid-drain, every stream against the k = 0 drain; the verify forward and a
decode iteration profiled; a draft-model run; paged prefill is also held
and timed at the verify shape) and the host KV tier (``phase_swap``: two
decoding slots swapped out and back in the drains beside a recompute
resume of the same context, prefix spill and revival with the revived
bytes checked, a pool with ``preempt_mode="auto"``). At reduced width
the TINY-scale windowed,
recurrent and RWKV stacks and the prefix-cache drains run paged on card
and CPU alike. Before the models it drives the
simulator path behind the paper's utility figures at the CLI's defaults
(``phase_sim``: the edge-serving simulator with SAC and the interference
predictor guard on the card, each baseline scheduler, the CLI, and a
greedy episode on the card against the CPU). Last come the rope2d,
M-RoPE / vision-frontend, encoder-decoder, windowed and llama-style
families at their published widths, one on the card at a time
(``phase_families``: chatglm3-6b paged, qwen2-vl-7b paged and dense,
starcoder2-15b dense, yi-34b cut to 16 of its 60 layers paged, each with
a round; seamless-m4t-large-v2 in round mode only, as the reference
serves it), their reduced configs card against CPU, and the paper's edge
nets at 224 x 224 with TinyBERT (``phase_edge``); the attention kernels
are also held and timed at these families' head sets (G = 16, 12 and 7
over 4 KV heads, MHA at hd 64, non-causal flash, starcoder2's 4096-slot
ring).

    python3 chip_smoke.py

Run from the root of a checkout. Exits non-zero, printing no result,
without a CUDA device or without the checkout's ``src/repro_torch``.
Every phase that fails raises; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Imports
nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
#: and fp32 flop/s outside the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
#: kernel vs plain version, fp32: summation order differs, nothing else
TOL = 1e-4
#: the model every main path serves at full width, and the recurrent
#: families served after it (dense continuous engine and round mode)
FULL = "qwen3-0.6b"
RECURRENT = ("recurrentgemma-2b", "rwkv6-3b")
#: the MoE family: arctic-480b served at full width cut to MOE_LAYERS
#: layer (one layer is 14.12 G parameters, 52.6 GiB in fp32; two would
#: not fit the card's 80 GB), both checked at reduced width
MOE = ("arctic-480b", "llama4-maverick-400b-a17b")
MOE_LAYERS = 1
#: kernel name -> the TPU kernel it replaces (file:line of its function)
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:164",
    "paged_decode_attention_splitk":
        "src/repro/kernels/decode_attention.py:274",
    "paged_prefill_attention": "src/repro/kernels/prefill_attention.py:85",
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
    "decode_attention": "src/repro/kernels/decode_attention.py:67",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:50",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:59",
    "moe_matmul": "src/repro/kernels/moe_matmul.py:36",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- phase 1
def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}, python "
        f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    if set(paths) != set(REPLACES):
        fail(f"build: kernels {sorted(paths)}, expected {sorted(REPLACES)}")
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel)")
    spills = []
    for name in paths:
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            if "spill" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads"):
                spills.append(f"{name} {entry}: {line.strip()}")
    for s in spills:
        log(f"  spill: {s}")
    if spills:
        fail(f"build: {len(spills)} kernel(s) spill registers")


# ---------------------------------------------------------------- phase 3
def _wrappers():
    """name -> (kernel wrapper, plain version)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import moe_matmul as mm
    from repro_torch.kernels import prefill_attention as pre
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rk

    return {"paged_decode_attention": (dec.paged_decode_attention,
                                       dec.paged_decode_attention_plain),
            "paged_decode_attention_splitk": (
                dec.paged_decode_attention_splitk,
                dec.paged_decode_attention_splitk_plain),
            "paged_prefill_attention": (pre.paged_prefill_attention,
                                        pre.paged_prefill_attention_plain),
            "flash_attention": (fl.flash_attention, fl.flash_attention_plain),
            "decode_attention": (dec.decode_attention,
                                 dec.decode_attention_plain),
            "rglru_scan": (rg.rglru_scan, rg.rglru_scan_plain),
            "rwkv6_scan": (rk.rwkv6_scan, rk.rwkv6_scan_plain),
            "moe_matmul": (mm.moe_matmul, mm.moe_matmul_plain)}


def reset_launches() -> None:
    for kern, _ in _wrappers().values():
        kern.launches = 0


def read_launches() -> dict:
    return {name: kern.launches for name, (kern, _) in _wrappers().items()}


def _poisoned_pools(torch, rng, n_pool, bs, KV, hd, live_slots, device):
    """Random pools whose every slot outside ``live_slots`` (a set of
    (block, slot) pairs) is NaN, block 0 included."""
    k = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    keep = np.zeros((n_pool, bs), bool)
    for blk, slot in live_slots:
        keep[blk, slot] = True
    k[~keep] = np.nan
    v[~keep] = np.nan
    return (torch.from_numpy(k).to(device), torch.from_numpy(v).to(device))


def _tables(rng, lens, nb, bs, n_pool):
    """Distinct shuffled live blocks per sequence; dead columns hold
    garbage: out-of-range ids, negative ids and the null block."""
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((len(lens), nb), np.int32)
    live, k = set(), 0
    for b, n in enumerate(lens):
        n_live = -(-n // bs)
        tables[b, :n_live] = perm[k:k + n_live]
        k += n_live
        garbage = np.array([2 ** 30, -7, 0, n_pool], np.int32)
        tables[b, n_live:] = garbage[np.arange(nb - n_live) % 4]
        for t in range(n):
            live.add((int(tables[b, t // bs]), t % bs))
    return tables, live


def paged_decode_case(torch, device, B=8, H=16, KV=8, hd=128, bs=16, nb=40,
                      seed=1):
    rng = np.random.default_rng(seed)
    lens = np.array([1, 17, 100, 257, 333, 480, 639, nb * bs][:B],
                    np.int32)
    n_pool = B * nb + 1
    tables, live = _tables(rng, lens, nb, bs, n_pool)
    kp, vp = _poisoned_pools(torch, rng, n_pool, bs, KV, hd, live, device)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(
        np.float32)).to(device)
    return dict(q=q, k_pool=kp, v_pool=vp,
                block_tables=torch.from_numpy(tables).to(device),
                seq_lens=torch.from_numpy(lens).to(device),
                scale=hd ** -0.5)


#: (B, nb): split-K at the shapes of the pool's decode (nb = 36: max_seq 576 of
#: a 500-token shared prefix) and of a 4096-token context, for one and eight
#: sequences, the pool's 4 slots over its 36 columns, then the two shapes the
#: dispatch sends on the main paths: the 8-slot drains (B = 8 over 40
#: columns, split-K) and ``serve_continuous`` at 32 slots (max_seq 128: 8
#: columns, one split); the one-split kernel is held against its plain
#: version at each shape
SPLITK_CASES = ((1, 36), (4, 36), (8, 36), (1, 256), (8, 256), (8, 40),
                (32, 8))
#: the split counts held at each (B, nb): all of SPLITK_SPLITS on tables of
#: at most 64 columns, SPLITK_WIDE_SPLITS (one, an uneven count, the most)
#: on wider ones, and the dispatch rule's count (``decode_splits``) on every
#: table
SPLITK_SPLITS = (1, 2, 3, 4, 8, 16)
SPLITK_WIDE_SPLITS = (1, 3, 16)
#: split-K vs its plain version and vs the unsplit kernel (fp32; the
#: splits change the order of the sum, nothing else)
SPLITK_TOL = 2e-6
#: the GQA groups the paged path serves at hd 128 over 8 KV heads:
#: qwen3-0.6b (G = 2), llama4-maverick (G = 5) and arctic-480b (G = 7)
PAGED_HEADS = ({"H": 16, "KV": 8}, {"H": 40, "KV": 8}, {"H": 56, "KV": 8})


def splitk_case(torch, device, B, nb, bs=16, H=16, KV=8, hd=128, full=False,
                seed=9):
    """q (B,1,H,hd) against poisoned pools through (B, nb) tables. Lengths
    are ragged and include 1 and the full table (one sequence: the full
    table), or all full with ``full``."""
    rng = np.random.default_rng(seed + B * nb)
    cap = nb * bs
    if full:
        lens = np.full(B, cap)
    else:
        lens = np.concatenate([[cap, 1][:B], rng.integers(2, cap, max(
            0, B - 2))])
    n_pool = B * nb + 1
    tables, live = _tables(rng, lens, nb, bs, n_pool)
    kp, vp = _poisoned_pools(torch, rng, n_pool, bs, KV, hd, live, device)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(
        np.float32)).to(device)
    return dict(q=q, k_pool=kp, v_pool=vp,
                block_tables=torch.from_numpy(tables).to(device),
                seq_lens=torch.from_numpy(lens.astype(np.int32)).to(device),
                scale=hd ** -0.5)


def paged_prefill_case(torch, device, T, pos, H=16, KV=8, hd=128, bs=16,
                       nb=40, seed=2):
    rng = np.random.default_rng(seed + T)
    n_pool = nb + 1
    tables, live = _tables(rng, [pos + T], nb, bs, n_pool)
    kp, vp = _poisoned_pools(torch, rng, n_pool, bs, KV, hd, live, device)
    q = torch.from_numpy(rng.standard_normal((1, T, H, hd)).astype(
        np.float32)).to(device)
    return dict(q=q, k_pool=kp, v_pool=vp,
                block_tables=torch.from_numpy(tables).to(device),
                pos=torch.tensor([pos], dtype=torch.int32, device=device),
                scale=hd ** -0.5)


#: the verify forward at the drains' engine: 8 slots of W = 1 + k rows
#: (k = 4), each at its own position over 40 columns (max_seq 640) plus
#: the ceil(4 / 16) = 1 null column the engine widens the table by; the
#: last slot sits 3 tokens from the cache's end, so its cap k_i is 2 and
#: rows 3 and 4 fall in the null column. VERIFY_TIMING_POS: every cap 4.
VERIFY_POS = (16, 47, 100, 255, 333, 480, 600, 637)
VERIFY_TIMING_POS = (31, 47, 100, 140, 270, 290, 530, 540)
VERIFY_W = 5


def verify_caps(pos, W=VERIFY_W, cap=640):
    """Each row's speculation cap k_i, as ``_step_speculative`` takes it
    (the cache's end only: every slot owes more than W tokens here)."""
    return [max(0, min(W - 1, cap - 1 - p)) for p in pos]


def paged_verify_case(torch, device, H=16, KV=8, hd=128, bs=16, nb=40,
                      pad=1, pos=VERIFY_POS, W=VERIFY_W, seed=7):
    """q (B,W,H,hd) of a verify forward: row b's slots 0..pos[b]+k_i live
    in its shuffled blocks, and so do the slots its rows past the cap
    write before they attend (the verify writes every row's K/V first:
    in its own blocks, or in the null block past its mapped columns);
    every other slot of the pools is NaN, the null block's included. The
    table's dead columns hold garbage ids and its ``pad`` widening
    columns the null block, as the engine's."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    caps = verify_caps(pos, W, nb * bs)
    lens = [p + k + 1 for p, k in zip(pos, caps)]
    n_pool = B * nb + 1
    tables, live = _tables(rng, lens, nb, bs, n_pool)
    for b, (p0, k) in enumerate(zip(pos, caps)):
        for t in range(p0 + k + 1, p0 + W):
            col = t // bs
            mapped = col < -(-lens[b] // bs)
            live.add((int(tables[b, col]) if mapped else 0, t % bs))
    kp, vp = _poisoned_pools(torch, rng, n_pool, bs, KV, hd, live, device)
    wide = np.zeros((B, nb + pad), np.int32)
    wide[:, :nb] = tables
    q = torch.from_numpy(rng.standard_normal((B, W, H, hd)).astype(
        np.float32)).to(device)
    return dict(q=q, k_pool=kp, v_pool=vp,
                block_tables=torch.from_numpy(wide).to(device),
                pos=torch.tensor(pos, dtype=torch.int32, device=device),
                scale=hd ** -0.5)


def _nan_headed(torch, a, device, extra_rows=64):
    """``a`` on the card as a contiguous tensor at the head of a flat
    buffer followed by ``extra_rows`` rows' worth (of axis 1) of NaN: a
    kernel reading past its last element (past S, T or W) reads NaN."""
    extra = extra_rows * (a.size // max(a.shape[1], 1))
    buf = torch.full((a.size + extra,), float("nan"), device=device)
    buf[:a.size] = torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(
        device)
    return buf[:a.size].view(a.shape)


def flash_case(torch, device, B, S, T, causal=True, window=None, H=16, KV=8,
               hd=128, seed=3):
    """Random q (B,S,H,hd), k/v (B,T,KV,hd); with B = 1 each lies at the
    head of a NaN-tailed buffer, so a read past S or T poisons the
    output."""
    rng = np.random.default_rng(seed + S + T)
    arrs = [rng.standard_normal((B, n, h, hd)).astype(np.float32)
            for n, h in ((S, H), (T, KV), (T, KV))]
    if B == 1:
        q, k, v = (_nan_headed(torch, a, device) for a in arrs)
    else:
        q, k, v = (torch.from_numpy(a).to(device) for a in arrs)
    return dict(q=q, k=k, v=v, scale=hd ** -0.5, causal=causal,
                window=window)


#: (B, S, T, causal, window): round-mode prefills (S = T, causal) at one
#: and eight prompts, a length off the 64-slot tile, a window, a
#: non-causal case with T off the tile and T != S, the same windowed, and
#: a causal one with more query rows than K/V rows (S > T: a tile runs
#: past T, and rows past T attend every K/V row)
FLASH_CASES = ((1, 16, 16, True, None), (1, 100, 100, True, None),
               (1, 512, 512, True, None), (8, 16, 16, True, None),
               (8, 100, 100, True, None), (8, 512, 512, True, None),
               (8, 512, 512, True, 64), (1, 40, 100, False, None),
               (1, 40, 100, False, 32), (1, 100, 40, True, None))

#: the local layers of recurrentgemma-2b: 10 query heads over one KV head
#: of 256 (MQA), window 2048 (wider than any prompt bucket), and the
#: reduced config's 64-slot window; then S > T and a non-causal window
#: (not timed)
RG_HEADS = {"H": 10, "KV": 1, "hd": 256}
FLASH_RG_CASES = ((1, 100, 100, True, 2048), (8, 512, 512, True, 2048),
                  (2, 512, 512, True, 64), (1, 100, 40, True, None),
                  (1, 40, 100, False, 32))


def decode_case(torch, device, C, mode, B=8, H=16, KV=8, hd=128, seed=4,
                window=64, front=None):
    """q (B,1,H,hd) against a dense (B, C, KV, hd) cache. ``mode``:
    "linear" (ragged frontiers, full capacity included), "round" (every
    row at one frontier, ``front`` or C - 16, as a round's lock-step
    decode), "ring" (the reference's ring mask with ``window``, wrapping
    ones included), or "sparse" (a few scattered valid slots, so most of
    the kernel's splits hold none, and one row with none at all, which
    both sides give as zeros). Returns the kernel's case (invalid slots
    NaN) and the plain version's (the same cache with them zeroed)."""
    rng = np.random.default_rng(seed + C)
    slots = np.arange(C)[None, :]
    if mode == "linear":  # past eight rows the frontiers repeat
        lens = np.resize([1, 17, 100, 257, 333, 480, C - 1, C], B)
        valid = slots < lens[:, None]
    elif mode == "round":
        valid = np.broadcast_to(slots < (front or C - 16), (B, C))
    elif mode == "ring":
        pos = np.array([5, 63, 64, 300, C - 1, C, C + 60, 3 * C + 7][:B])
        k_pos = pos[:, None] - ((pos[:, None] - slots) % C)
        valid = (k_pos >= 0) & (k_pos > pos[:, None] - window)
    else:  # sparse: row b has b scattered valid slots, row 0 none
        valid = np.zeros((B, C), bool)
        for b in range(1, B):
            valid[b, rng.choice(C, b, replace=False)] = True
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k0, v0 = np.where(valid[..., None, None], k, 0), \
        np.where(valid[..., None, None], v, 0)
    k[~valid], v[~valid] = np.nan, np.nan

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    vt = t(valid)
    return (dict(q=t(q), k=t(k), v=t(v), valid=vt, scale=hd ** -0.5),
            dict(q=t(q), k=t(k0), v=t(v0), valid=vt, scale=hd ** -0.5))


#: (C, mode): the round's cache (prompt bucket 512 + 32 new tokens) and
#: the dense continuous engine's (max_seq 640), then a ring mask and
#: empty splits
DECODE_CASES = ((544, "round"), (544, "linear"), (640, "linear"),
                (640, "ring"), (640, "sparse"))

#: (C, mode, extra): recurrentgemma-2b's local layers: a round's
#: 2048-slot ring filled to 528 (prompt bucket 512 + 16 tokens), the
#: dense engine's 640-slot rows, a 2048-slot ring wrapping with window
#: 2048, the reduced config's 64-slot ring, and empty splits
DECODE_RG_CASES = ((2048, "round", {"front": 528}), (640, "linear", {}),
                   (2048, "ring", {"window": 2048}),
                   (64, "ring", {"window": 64}), (2048, "sparse", {}))

#: (B, C, mode): where the split rule takes one split at 8 KV heads: 32
#: slots of a dense engine (B.KV = 256 > 132 SMs) and a cache of one
#: 16-slot column
DECODE_ONE_SPLIT_CASES = ((32, 640, "linear"), (8, 16, "linear"))

#: (B, S, W): rglru_scan at recurrentgemma-2b's width 2560, one and
#: eight 512-token sequences (two passes and one pass), a ragged case off
#: every tile, two passes with a ragged last chunk (16 chunks of 63
#: steps, the last 55), and a width off 4 floats (4-byte copies)
RGLRU_CASES = ((1, 512, 2560), (8, 512, 2560), (2, 33, 100),
               (1, 1000, 2560), (2, 70, 33))
#: the decays a each RGLRU case is drawn from: those of tests/test_kernels.py
#: and recurrentgemma-2b's (0.9, 0.999) at r = 1 (models/rglru.py)
RGLRU_DECAYS = ((0.4, 0.9), (0.9, 0.999))
#: (B, S, H, hd): rwkv6_scan at rwkv6-3b's 40 heads of 64, one and
#: eight 512-token sequences, the largest head size (128), hd 48 over
#: six column groups of 8, and a head size off 4 floats (4-byte copies)
RWKV_CASES = ((1, 512, 40, 64), (8, 512, 40, 64), (1, 64, 1, 128),
              (1, 77, 3, 48), (2, 9, 2, 5))


def rglru_case(torch, device, B, S, W, seed=5, decay=RGLRU_DECAYS[0]):
    """The distributions of tests/test_kernels.py: a uniform in ``decay``
    (there (0.4, 0.9)), x and h0 normal; every input at the head of a
    NaN-tailed buffer."""
    rng = np.random.default_rng(seed + B * S + W)
    lo, hi = decay
    arrs = {"a": rng.random((B, S, W)) * (hi - lo) + lo,
            "x": rng.standard_normal((B, S, W)) * 0.3,
            "h0": rng.standard_normal((B, W)) * 0.1}
    return {n: _nan_headed(torch, a.astype(np.float32), device)
            for n, a in arrs.items()}


def rwkv_case(torch, device, B, S, H, hd, seed=6, model_w=False):
    """The distributions of tests/test_kernels.py: w in (0.4, 0.9), the
    rest normal; with ``model_w``, w = exp(-exp(z)) with z uniform in
    (-6, 1), rwkv6-3b's range of w_base (models/rwkv.py), so w spans
    0.066 to 0.9975. Every input at the head of a NaN-tailed buffer."""
    rng = np.random.default_rng(seed + B * S + H * hd)
    seq = (B, S, H, hd)
    w = (np.exp(-np.exp(rng.uniform(-6.0, 1.0, seq))) if model_w
         else rng.random(seq) * 0.5 + 0.4)
    arrs = {"r": rng.standard_normal(seq),
            "k": rng.standard_normal(seq) * 0.3,
            "v": rng.standard_normal(seq) * 0.3,
            "w": w,
            "u": rng.standard_normal((H, hd)) * 0.1,
            "state": rng.standard_normal((B, H, hd, hd)) * 0.1}
    return {n: _nan_headed(torch, a.astype(np.float32), device)
            for n, a in arrs.items()}


#: (E, C, d, f): moe_matmul at the shapes of tests/test_kernels.py (C, d
#: and f off the kernel's 8/16-row, 64-deep and 512-column tiles)
MOE_REF_CASES = ((2, 32, 64, 48), (4, 40, 48, 56), (8, 16, 128, 128))
#: (E, C, d, f) at full-width arctic-480b (128 experts, d 7168, expert
#: width 4864): the capacity of a decode iteration over 8 slots (top-2,
#: 8.0 slots of 8) and of a 512-token prefill chunk (16), for
#: w_gate/w_up; w_down swaps d and f. The timing rows: those two (a
#: round's one-shot prefill at b=8, S=512, C = 80, is no longer timed)
MOE_ARCTIC = (128, 7168, 4864)
MOE_ARCTIC_CASES = ((128, 8, 7168, 4864), (128, 16, 7168, 4864),
                    (128, 8, 4864, 7168))
MOE_TIMING_CASES = ((128, 8, 7168, 4864), (128, 16, 7168, 4864))


def _nan_headed_randn(torch, shape, scale, device, gen, extra_rows=64):
    """N(0, scale^2) drawn on the card (a 17.9 GB weight is not built on
    the host) at the head of a buffer followed by ``extra_rows`` rows'
    worth (of axis 1) of NaN, as ``_nan_headed``."""
    n = int(np.prod(shape))
    buf = torch.full((n + extra_rows * (n // shape[1]),), float("nan"),
                     device=device)
    buf[:n].normal_(generator=gen).mul_(scale)
    return buf[:n].view(shape)


def moe_case(torch, device, E, C, D, F, seed=8):
    """x normal and w normal * 0.1 (tests/test_kernels.py) at the small
    shapes; at arctic's the model's scales, x normal (a normed
    activation) and w * D^-0.5 (moe_init), so outputs are O(1) as in the
    model. Both at the head of NaN-tailed buffers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + E * C + D)
    w_scale = 0.1 if (E, C, D, F) in MOE_REF_CASES else D ** -0.5
    return {"x": _nan_headed_randn(torch, (E, C, D), 1.0, device, gen),
            "w": _nan_headed_randn(torch, (E, D, F), w_scale, device, gen)}

#: (T, pos): one row at the last slot, chunks starting mid-block, a full
#: 512-token first chunk and one that ends at the full 640 capacity
PREFILL_CASES = ((1, 639), (16, 8), (128, 200), (512, 0), (512, 128))

#: the head sets of the rope2d, M-RoPE / vision-frontend, windowed,
#: encoder-decoder and 34B families (G = 16 and 12, 7 at 4 KV heads, plain
#: MHA at hd 64, G = 7 at 8 KV heads), each with its path shapes:
#: ``splitk`` (B, nb): the 4-slot drains' tables (max_seq 640: 40 columns;
#: qwen2-vl's 2048: 128) and one sequence; ``flash`` (B, S, T, causal,
#: window): round prefills at their batch (bucket 512), starcoder2's 4096
#: window, qwen2-vl's 1,024 frontend positions ahead of a 16..512-token
#: bucket, seamless's encoder (T_enc x T_enc, non-causal), its prefill
#: cross-attention (S x T_enc) and non-causal cases with T off the 64-slot
#: tile, S > T causal; ``decode`` (B, C, mode, extra) of dense decode: a
#: b-row round's cache (prefill bucket + 16 tokens; qwen2-vl's 1,024 + 512
#: + 16), the 4-slot dense drains' rows (starcoder2's ring holds max_seq
#: 640 slots there), starcoder2's round ring of 4096 slots filled to 528
#: and full, and wrapping under its window; seamless's cross-attention, one
#: query against every T_enc row (32 and 128: prompt buckets 128 and 512)
FAMILY_CASES = {
    "chatglm3-6b": {
        "heads": {"H": 32, "KV": 2},
        "splitk": ((4, 40), (1, 36)),
        "flash": ((1, 100, 100, True, None), (4, 512, 512, True, None),
                  (1, 100, 40, True, None)),
        "decode": ((4, 528, "round", {}), (4, 640, "linear", {}))},
    "starcoder2-15b": {
        "heads": {"H": 48, "KV": 4},
        "splitk": ((4, 40), (1, 36)),
        "flash": ((4, 512, 512, True, 4096), (1, 100, 100, True, 4096),
                  (2, 512, 512, True, 64)),
        "decode": ((4, 4096, "round", {"front": 528}),
                   (4, 4096, "round", {"front": 4096}),
                   (8, 4096, "ring", {"window": 4096}),
                   (4, 640, "linear", {}))},
    "qwen2-vl-7b": {
        "heads": {"H": 28, "KV": 4},
        "splitk": ((4, 128), (1, 36)),
        "flash": ((2, 1088, 1088, True, None), (1, 1040, 1040, True, None),
                  (2, 1536, 1536, True, None)),
        "decode": ((2, 1552, "round", {}), (4, 2048, "linear", {}))},
    "seamless-m4t-large-v2": {
        "heads": {"H": 16, "KV": 16, "hd": 64},
        "splitk": ((4, 40), (1, 36)),
        "flash": ((4, 512, 512, True, None), (4, 128, 128, False, None),
                  (4, 512, 128, False, None), (1, 100, 37, False, None),
                  (1, 40, 100, False, None)),
        "decode": ((4, 528, "round", {}), (4, 32, "round", {"front": 32}),
                   (4, 128, "round", {"front": 128}),
                   (8, 640, "linear", {}))},
    "yi-34b": {
        "heads": {"H": 56, "KV": 8},
        "splitk": ((4, 40),),
        "flash": ((4, 512, 512, True, None),),
        "decode": ((4, 528, "round", {}),)},
}


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def _check(torch, name, got, want, what, tol=TOL, vs="plain"):
    """Max abs error of every output of ``got`` against ``want``; fails
    on a non-finite output or an error above ``tol``."""
    err = 0.0
    for g, w in zip(_outputs(got), _outputs(want)):
        if not torch.isfinite(g).all():
            fail(f"{name} {what}: non-finite output (poison read)")
        err = max(err, float((g - w).abs().max()))
    log(f"{name} {what}: max abs err vs {vs} {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        fail(f"{name} {what} disagrees with {vs}: {err:.3e} > {tol:g}")
    return err


def phase_kernels(torch, device):
    """Every kernel vs its plain version at the main paths' shapes, on
    poisoned inputs. Returns name -> worst max abs error."""
    from repro_torch.kernels.decode_attention import dense_split_plan
    from repro_torch.kernels.rglru_scan import rglru_plan
    from repro_torch.kernels.rwkv6_scan import rwkv6_plan

    w = _wrappers()
    errs = {name: 0.0 for name in w}

    def run(name, what, kern_args, plain_args=None):
        kern, plain = w[name]
        got = kern(**kern_args)
        want = plain(**(plain_args or kern_args))
        errs[name] = max(errs[name], _check(torch, name, got, want, what))

    def run_verify(heads):
        """The verify shape: rows j <= k_i of each slot against the plain
        version (rows past the cap read the poisoned null block, and
        their logits are ignored by the engine)."""
        name = "paged_prefill_attention"
        c = paged_verify_case(torch, device, **heads)
        caps = verify_caps(VERIFY_POS)
        got, want = w[name][0](**c), w[name][1](**c)
        keep = torch.zeros(got.shape[:2], dtype=torch.bool, device=device)
        for b, k in enumerate(caps):
            keep[b, :k + 1] = True
        H, hd = c["q"].shape[2], c["q"].shape[3]
        errs[name] = max(errs[name], _check(
            torch, name, got[keep], want[keep],
            f"verify q ({len(VERIFY_POS)},{VERIFY_W},{H},{hd}) KV "
            f"{c['k_pool'].shape[2]} pos {list(VERIFY_POS)} tables "
            f"{tuple(c['block_tables'].shape)} (one null column), rows "
            f"<= k_i {caps}"))

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for heads in PAGED_HEADS:
        c = paged_decode_case(torch, device, **heads)
        run("paged_decode_attention", f"q {tuple(c['q'].shape)} pools "
            f"{tuple(c['k_pool'].shape)} seq_lens {c['seq_lens'].tolist()}",
            c)
        H = heads["H"]
        _check_splitk(torch, device, w, errs, heads, SPLITK_CASES, n_sm)
        for T, pos in PREFILL_CASES:
            run("paged_prefill_attention", f"q (1,{T},{H},128) pos {pos}",
                paged_prefill_case(torch, device, T, pos, **heads))
        run_verify(heads)
    # MQA at hd 256 (recurrentgemma-2b's local heads): no paged path
    # sends it, and the kernels stay right for it
    c = paged_decode_case(torch, device, **RG_HEADS)
    run("paged_decode_attention", "q (8,1,10,256) KV 1 (MQA)", c)
    _check_splitk(torch, device, w, errs, RG_HEADS, ((4, 36),), n_sm,
                  "MQA ")
    for T, pos in ((512, 0), (100, 37)):
        run("paged_prefill_attention", f"q (1,{T},10,256) KV 1 (MQA) pos "
            f"{pos}", paged_prefill_case(torch, device, T, pos, **RG_HEADS))
    run_verify(RG_HEADS)
    del c
    torch.cuda.empty_cache()
    # flash and dense decode run the same bodies at the same groups
    dec = w["decode_attention"][0]

    def run_decode(C, mode, **kw):
        """Dense decode at the split rule's count against its plain
        version, then one split (four where the rule takes one) against
        the rule's on the same inputs."""
        kc, pc = decode_case(torch, device, C, mode, **kw)
        B, _, H, hd = kc["q"].shape
        KV = kc["k"].shape[2]
        extra = {x: kw[x] for x in ("window", "front") if x in kw}
        what = (f"q ({B},1,{H},{hd}) KV {KV} C={C} {mode}"
                f"{' ' + str(extra) if extra else ''}, "
                f"{int(kc['valid'].sum())} valid slots")
        S, _ = dense_split_plan(B, KV, C, n_sm)
        run("decode_attention", f"{what}, {S} split(s)", kc, pc)
        alt = 1 if S > 1 else 4
        errs["decode_attention"] = max(
            errs["decode_attention"],
            _check(torch, "decode_attention", dec(**kc, n_splits=alt),
                   dec(**kc), f"{what}, n_splits {alt}", SPLITK_TOL,
                   f"the rule's {S} split(s)"))

    for heads in PAGED_HEADS:
        H = heads["H"]
        for B, S, T, causal, window in FLASH_CASES:
            c = flash_case(torch, device, B, S, T, causal, window, **heads)
            run("flash_attention", f"H={H} KV=8 B={B} S={S} T={T} "
                f"causal={causal} window={window}", c)
            del c
        for C, mode in DECODE_CASES:
            run_decode(C, mode, **heads)
        for B, C, mode in DECODE_ONE_SPLIT_CASES:
            run_decode(C, mode, B=B, **heads)
        torch.cuda.empty_cache()
    for B, S, T, causal, window in FLASH_RG_CASES:
        c = flash_case(torch, device, B, S, T, causal, window, **RG_HEADS)
        run("flash_attention", f"H=10 KV=1 hd=256 B={B} S={S} T={T} "
            f"causal={causal} window={window}", c)
    for C, mode, extra in DECODE_RG_CASES:
        run_decode(C, mode, **RG_HEADS, **extra)
    for B, S, W in RGLRU_CASES:
        plan = rglru_plan(B, S, W, n_sm)
        for decay in RGLRU_DECAYS:
            run("rglru_scan", f"(B,S,W)=({B},{S},{W}) a in {decay}, plan "
                f"(channels, chunks, length) {plan}, NaN-tailed inputs",
                rglru_case(torch, device, B, S, W, decay=decay))
    for B, S, H, hd in RWKV_CASES:
        plan = rwkv6_plan(B, H, hd, n_sm)
        for model_w in (False, True):
            run("rwkv6_scan", f"(B,S,H,hd)=({B},{S},{H},{hd}) w in "
                f"{'(0.066, 0.9975)' if model_w else '(0.4, 0.9)'}, plan "
                f"(columns, threads, rows) {plan}, NaN-tailed inputs",
                rwkv_case(torch, device, B, S, H, hd, model_w=model_w))
    for E, C, D, F in MOE_REF_CASES + MOE_ARCTIC_CASES:
        c = moe_case(torch, device, E, C, D, F)
        run("moe_matmul", f"x ({E},{C},{D}) @ w ({E},{D},{F}), NaN-tailed "
            "inputs", c)
        del c
        torch.cuda.empty_cache()
    _family_kernels(torch, device, w, run, run_decode, errs)
    phase_grads(torch, device)
    return errs


#: the gradient checks: max |Function grad - plain autograd grad| over
#: max |plain autograd grad|, per input (fp32 sums in another order; the
#: CPU tests hold the same backward code to plain autograd to 1e-5)
GRAD_TOL = 1e-4
#: (B, S, T, H, KV, hd, causal, window): qwen3-0.6b's training step,
#: recurrentgemma-2b's local layers (MQA at hd 256, window 2048, and a
#: binding window), and seamless's cross attention at hd 64 (non-causal,
#: S != T)
GRAD_FLASH = ((4, 256, 256, 16, 8, 128, True, None),
              (2, 512, 512, 10, 1, 256, True, 2048),
              (1, 300, 300, 10, 1, 256, True, 64),
              (4, 512, 128, 16, 16, 64, False, None))
#: kernel launches of one forward and backward: flash's backward is torch
#: ops, the RG-LRU's is the scan over reversed time, the expert GEMM's
#: the kernel twice, RWKV-6's a torch-op reverse pass
GRAD_LAUNCHES = {"flash_attention": 1, "rglru_scan": 2, "rwkv6_scan": 1,
                 "moe_matmul": 3}


def _grad_check(torch, device, name, fn, plain, inputs, what, seed):
    """Gradients of ``fn`` (the kernel's autograd Function) against
    autograd of ``plain`` on the same (poisoned) inputs and seeded
    cotangents, on the card; checks the launches one forward and
    backward makes. Returns the worst relative error."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def run(f):
        ins = [t.detach().requires_grad_() for t in inputs]
        outs = _outputs(f(*ins))
        return ins, outs

    reset_launches()
    ins, outs = run(fn)
    cots = [torch.randn(o.shape, generator=gen, device=device)
            for o in outs]
    got = torch.autograd.grad(outs, ins, cots)
    torch.cuda.synchronize()
    n = read_launches()[name]
    if n != GRAD_LAUNCHES[name]:
        fail(f"{name} grad {what}: {n} launches, expected "
             f"{GRAD_LAUNCHES[name]}")
    ins2, outs2 = run(plain)
    want = torch.autograd.grad(outs2, ins2, cots)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.isfinite(g).all():
            fail(f"{name} grad {what}: non-finite gradient of input {i}")
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
    log(f"{name} grad {what}: {n} launches; worst input's max |diff| / "
        f"max |plain grad| {worst:.3e} (tolerance {GRAD_TOL:g})")
    if not worst <= GRAD_TOL:
        fail(f"{name} grad {what} disagrees with plain autograd: "
             f"{worst:.3e} > {GRAD_TOL:g}")
    return worst


def phase_grads(torch, device):
    """The four kernels that training runs, each through its autograd
    Function on the card, against autograd of its plain version."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import moe_matmul as mm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rk

    for B, S, T, H, KV, hd, causal, window in GRAD_FLASH:
        c = flash_case(torch, device, B, S, T, causal, window, H=H, KV=KV,
                       hd=hd)
        kw = {x: c[x] for x in ("scale", "causal", "window")}
        _grad_check(torch, device, "flash_attention",
                    lambda q, k, v: fl.flash_attention(q, k, v, **kw),
                    lambda q, k, v: fl.flash_attention_plain(q, k, v, **kw),
                    [c["q"], c["k"], c["v"]],
                    f"q ({B},{S},{H},{hd}) KV {KV} T={T} causal={causal} "
                    f"window={window}", seed=B + S)
    c = rglru_case(torch, device, 2, 512, 2560, decay=RGLRU_DECAYS[1])
    _grad_check(torch, device, "rglru_scan", rg.rglru_scan,
                rg.rglru_scan_plain, [c["a"], c["x"], c["h0"]],
                "(2,512,2560) a in (0.9, 0.999), NaN-tailed inputs", seed=2)
    c = rwkv_case(torch, device, 1, 256, 40, 64, model_w=True)
    _grad_check(torch, device, "rwkv6_scan", rk.rwkv6_scan,
                rk.rwkv6_scan_plain,
                [c[x] for x in ("r", "k", "v", "w", "u", "state")],
                "(1,256,40,64) w in (0.066, 0.9975), u and state "
                "included, NaN-tailed inputs", seed=3)
    c = moe_case(torch, device, 8, 64, 1024, 2048)
    _grad_check(torch, device, "moe_matmul", mm.moe_matmul,
                mm.moe_matmul_plain, [c["x"], c["w"]],
                "x (8,64,1024) @ w (8,1024,2048), NaN-tailed inputs",
                seed=4)
    del c
    torch.cuda.empty_cache()


def _check_splitk(torch, device, w, errs, heads, cases, n_sm, tag=""):
    """Split-K at ``heads`` over each (B, nb) of ``cases``, on poisoned
    pools: the one-split kernel against its plain version, then each
    split count (``SPLITK_SPLITS`` or, past 64 columns,
    ``SPLITK_WIDE_SPLITS``, and the dispatch rule's) against its plain
    version and against the one-split kernel."""
    from repro_torch.kernels.decode_attention import decode_splits

    split, split_plain = w["paged_decode_attention_splitk"]
    whole, whole_plain = w["paged_decode_attention"]
    H, KV, hd = heads["H"], heads["KV"], heads.get("hd", 128)
    for B, nb in cases:
        c = splitk_case(torch, device, B, nb, **heads)
        ref = whole(**c)
        what = (f"{tag}q ({B},1,{H},{hd}) KV {KV} tables ({B},{nb}) "
                f"seq_lens {c['seq_lens'].tolist()}")
        errs["paged_decode_attention"] = max(
            errs["paged_decode_attention"],
            _check(torch, "paged_decode_attention", ref, whole_plain(**c),
                   what))
        rule = decode_splits(B, KV, nb, n_sm)
        counts = SPLITK_SPLITS if nb <= 64 else SPLITK_WIDE_SPLITS
        for n in sorted({*counts, rule}):
            got = split(**c, n_splits=n)
            at = f"{what} n_splits {n} (rule {rule})"
            errs["paged_decode_attention_splitk"] = max(
                errs["paged_decode_attention_splitk"],
                _check(torch, "paged_decode_attention_splitk", got,
                       split_plain(**c, n_splits=n), at, SPLITK_TOL),
                _check(torch, "paged_decode_attention_splitk", got, ref, at,
                       SPLITK_TOL, "the unsplit kernel"))
        del c, ref
    torch.cuda.empty_cache()


def _family_kernels(torch, device, w, run, run_decode, errs):
    """The five attention kernels at each head set of ``FAMILY_CASES``,
    on the same poisoned pools and NaN-headed buffers: paged decode,
    split-K, paged prefill, flash (causal, windowed and non-causal) and
    dense decode at the family paths' shapes. A head set of
    ``PAGED_HEADS`` (yi-34b's is arctic's) already has its paged decode
    and prefill cases held by ``phase_kernels``, on the same inputs."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for arch, case in FAMILY_CASES.items():
        heads = case["heads"]
        H, KV, hd = heads["H"], heads["KV"], heads.get("hd", 128)
        tag = f"{arch} heads ({H},{KV},{hd})"
        if heads not in PAGED_HEADS:
            c = paged_decode_case(torch, device, **heads)
            run("paged_decode_attention", f"{tag} q {tuple(c['q'].shape)} "
                f"seq_lens {c['seq_lens'].tolist()}", c)
            for T, pos in ((1, 639), (16, 8), (128, 200), (512, 0)):
                run("paged_prefill_attention", f"{tag} q (1,{T},{H},{hd}) "
                    f"pos {pos}", paged_prefill_case(torch, device, T, pos,
                                                     **heads))
        _check_splitk(torch, device, w, errs, heads, case["splitk"], n_sm,
                      f"{tag} ")
        for B, S, T, causal, window in case["flash"]:
            c = flash_case(torch, device, B, S, T, causal, window, **heads)
            run("flash_attention", f"{tag} B={B} S={S} T={T} "
                f"causal={causal} window={window}", c)
            del c
        for B, C, mode, extra in case["decode"]:
            run_decode(C, mode, B=B, **heads, **extra)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def _time_ms(torch, fn, n_args, iters=20):
    """Mean device ms per call over ``iters`` calls cycling through
    ``n_args`` input copies (together larger than the 50 MB L2, so each
    call finds its inputs cold, as a layer of the model does)."""
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, n_args, calls=20, tries=3):
    """Device ms per call of ``fn(i)`` over ``calls`` calls cycling
    through ``n_args`` input copies, from the profiler's kernel
    durations: each kernel's mean over the events recorded, times its
    launches per call (its events over ``calls``, rounded, at least 1),
    summed over the call's kernels, so an event the profiler drops cannot
    lower the time. A window in which the profiler recorded no device
    event at all is profiled again, up to ``tries`` windows. Returns (ms,
    events recorded per kernel)."""
    for _ in range(tries):
        counts = {}
        _, _, _, names = _profiled(
            torch, lambda: [fn(i % n_args) for i in range(calls)], counts)
        if names:
            break
    else:
        fail(f"profiler recorded no device event in {tries} windows")
    ms = sum(t / counts[k] * max(1, round(counts[k] / calls))
             for k, t in names.items())
    return ms, sorted(counts.values())


def _sdpa(torch, q, k, v, mask, scale):
    """scaled_dot_product_attention, q (B,T,H,hd) against k/v
    (B,KV,S,hd) (GQA)."""
    F = torch.nn.functional
    qh = q.transpose(1, 2)  # (B, H, T, hd)
    try:
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand the KV heads
        rep = qh.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            qh, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask, scale=scale)


def _bound(n_bytes, flops):
    """Least time on the card: bytes over HBM, flops over fp32 peak.
    Returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _paged_job(torch, device, make, kw):
    """Inputs, library yardstick and bound of a paged kernel at one shape:
    the library call is SDPA over the pre-gathered logical view; the
    bound counts q, the live K/V slots and table entries read once, the
    output written once, and 4 * hd flops per (query head, attended
    slot)."""
    copies = [make(torch, device, seed=10 + i, **kw) for i in range(4)]
    c0 = copies[0]
    B, T, H, hd = c0["q"].shape
    N, bs, KV, _ = c0["k_pool"].shape
    if "seq_lens" in c0:
        last = [(c["seq_lens"].long() - 1)[:, None] for c in copies]
    else:
        last = [c["pos"].long()[:, None]
                + torch.arange(T, device=device)[None] for c in copies]
    lib_in = []
    for c, lst in zip(copies, last):
        nb = c["block_tables"].shape[1]
        tbl = c["block_tables"].long()
        live = (torch.arange(nb, device=device)[None] * bs
                <= lst[:, -1:]) & (tbl >= 0) & (tbl < N)
        tbl = torch.where(live, tbl, 0)
        mask = torch.arange(nb * bs, device=device)[None, None, :] \
            <= lst[:, :, None]
        rows = mask.any(1)[:, :, None, None]
        k = torch.where(rows, c["k_pool"][tbl].reshape(B, nb * bs, KV, hd),
                        0.0)
        v = torch.where(rows, c["v_pool"][tbl].reshape(B, nb * bs, KV, hd),
                        0.0)
        lib_in.append((k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), mask[:, None]))

    def lib(i):
        k, v, mask = lib_in[i]
        return _sdpa(torch, copies[i]["q"], k, v, mask, c0["scale"])

    attended = (last[0] + 1).clamp(min=0)              # (B, T)
    per_seq = attended.max(1).values                    # K/V slots read
    n_bytes = (2 * c0["q"].numel() * 4 + int(per_seq.sum()) * KV * hd * 8
               + 4 * int((-(-per_seq // bs)).sum()) + 4 * B)
    flops = 4 * H * hd * int(attended.sum())
    return copies, copies, lib, _bound(n_bytes, flops), \
        f"q {tuple(c0['q'].shape)} tables {tuple(c0['block_tables'].shape)}"


def _splitk_job(torch, device, B, nb, n_splits, **heads):
    """Split-K at ``n_splits``, every sequence at the full table (nb * 16
    tokens). Beside it the one-split kernel on the same inputs; the
    library call is SDPA over the gathered view (``_paged_job``). The
    bound is what the function must move, as ``_paged_job`` counts it:
    the partials acc (B,H,S,hd), m and l (B,H,S), written and read back,
    are the kernel's own overhead (their bytes are in the label)."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, split_plan)

    copies, _, lib, _, what = _paged_job(
        torch, device, splitk_case, {"B": B, "nb": nb, "full": True,
                                     **heads})
    c0 = copies[0]
    H, hd, KV = c0["q"].shape[2], c0["q"].shape[3], c0["k_pool"].shape[2]
    S, _ = split_plan(nb, n_splits)
    k_args = [dict(c, n_splits=n_splits) for c in copies]
    attended = int(c0["seq_lens"].sum())
    one = (2 * c0["q"].numel() * 4 + attended * KV * hd * 8 + 4 * B * nb
           + 4 * B)
    flops = 4 * H * hd * attended
    partials = 2 * 4 * B * H * S * (hd + 2)
    whole = {"unsplit": lambda i: paged_decode_attention(**copies[i])}
    return k_args, k_args, lib, _bound(one, flops), \
        (f"{what} B.KV {B * KV} lens {nb * 16} n_splits {S} (partials "
         f"{partials} bytes written and read back, not in the bound)"), whole


def _flash_job(torch, device, B, S, T, causal, window, **heads):
    """The library call is SDPA with the same bool mask; the bound counts
    q, k, v read once, the output written once, and 4 * hd flops per
    (query head, attended pair)."""
    copies = [flash_case(torch, device, B, S, T, causal, window, seed=20 + i,
                         **heads) for i in range(4)]
    c0 = copies[0]
    H, hd = c0["q"].shape[2], c0["q"].shape[3]
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    kv_t = [(c["k"].transpose(1, 2).contiguous(),
             c["v"].transpose(1, 2).contiguous()) for c in copies]

    def lib(i):
        return _sdpa(torch, copies[i]["q"], *kv_t[i], mask, c0["scale"])

    n_bytes = 4 * (2 * c0["q"].numel() + c0["k"].numel() + c0["v"].numel())
    flops = 4 * B * H * hd * int(mask.sum())
    return copies, copies, lib, _bound(n_bytes, flops), \
        f"B={B} S={S} T={T} causal={causal} window={window} {heads or ''}"


def _decode_job(torch, device, C, mode, **kw):
    """The library call is SDPA over the zeroed cache under the validity
    mask; the bound counts q, the valid K/V slots and the mask read once,
    the output written once."""
    pairs = [decode_case(torch, device, C, mode, seed=30 + i, **kw)
             for i in range(4)]
    kern = [k for k, _ in pairs]
    plain = [p for _, p in pairs]
    c0 = plain[0]
    B, _, H, hd = c0["q"].shape
    KV = c0["k"].shape[2]
    kv_t = [(p["k"].transpose(1, 2).contiguous(),
             p["v"].transpose(1, 2).contiguous(),
             p["valid"][:, None, None, :]) for p in plain]

    def lib(i):
        return _sdpa(torch, plain[i]["q"], *kv_t[i], c0["scale"])

    n_valid = int(c0["valid"].sum())
    n_bytes = 2 * c0["q"].numel() * 4 + n_valid * KV * hd * 8 + B * C
    flops = 4 * H * hd * n_valid
    return kern, plain, lib, _bound(n_bytes, flops), \
        f"q {tuple(c0['q'].shape)} C={C} {mode} {kw or ''}"


def _copies(n_bytes):
    """Input copies to cycle through so that together they exceed the
    50 MB L2 three times over (4 to 16)."""
    return int(min(16, max(4, -(-150e6 // n_bytes))))


def _rglru_job(torch, device, B, S, W):
    """No single PyTorch call computes the recurrence (library none); the
    bound counts a, x and h0 read once, hs and the final h written once,
    and 2 flops per (b, t, w)."""
    from repro_torch.kernels.rglru_scan import rglru_plan

    n_bytes = 4 * (3 * B * S * W + 2 * B * W)
    copies = [rglru_case(torch, device, B, S, W, seed=40 + i)
              for i in range(_copies(n_bytes))]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return copies, copies, None, _bound(n_bytes, 2 * B * S * W), \
        f"(B,S,W)=({B},{S},{W}) plan {rglru_plan(B, S, W, n_sm)}"


def _rwkv_job(torch, device, B, S, H, hd):
    """No single PyTorch call computes the recurrence (library none); the
    bound counts r, k, v, w, u and the state read once, the output and
    the final state written once, and 5 * hd^2 + 5 * hd flops per (b, t,
    head): r . S over the keys (2 hd^2), the decay and the k v^T update
    (3 hd^2), and the bonus, which factors as v_j * sum_i r_i u_i k_i
    (5 hd)."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_plan

    n_bytes = 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    copies = [rwkv_case(torch, device, B, S, H, hd, seed=50 + i)
              for i in range(_copies(n_bytes))]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return copies, copies, None, _bound(n_bytes, B * S * H * (5 * hd * hd + 5 * hd)), \
        f"(B,S,H,hd)=({B},{S},{H},{hd}) plan {rwkv6_plan(B, H, hd, n_sm)}"


def _moe_job(torch, device, E, C, D, F):
    """The library call is ``torch.bmm`` (fp32, TF32 off); the bound counts
    x and w read once, the output written once, and 2 flops per (e, c,
    d, f). One copy of each input: w alone (17.9 GB at arctic's widths)
    is far past the 50 MB L2."""
    c = moe_case(torch, device, E, C, D, F, seed=60)

    def lib(i):
        return torch.bmm(c["x"], c["w"])

    n_bytes = 4 * (E * C * D + E * D * F + E * C * F)
    return [c], [c], lib, _bound(n_bytes, 2 * E * C * D * F), \
        f"x ({E},{C},{D}) @ w ({E},{D},{F})"


#: (B, nb) of the paged decode dispatch grid in ``phase_timing``: the
#: pool's B = 4 on 36 columns first (the split-K row of the result line),
#: then B = 1, 8 and 32 on the drains' 40 columns and a 4096-token table
#: (B = 4 and 16 on 40 columns, serve_continuous's 8 columns at 4 and 32
#: slots and B = 1..32 on 36 columns were dropped for time)
DECODE_GRID = ((4, 36),) + tuple((B, 40) for B in (1, 8, 32)) \
    + ((4, 256),)


def phase_timing(torch, device, smi):
    """CUDA-event times of kernel, plain version and the library call, in
    the order plain, kernel, kernel, plain (library at both ends). The
    first shape of each kernel is its row in the result line. Flash,
    dense decode and the scans are timed at their first path shape only
    (PERF.md keeps the numbers of the others)."""
    from repro_torch.kernels.decode_attention import decode_splits

    w = _wrappers()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    # the one-split kernel's row: the shape the dispatch sends it,
    # serve_continuous at 32 slots over 8-column tables, ragged
    jobs = [("paged_decode_attention", lambda: _paged_job(
        torch, device, splitk_case, {"B": 32, "nb": 8}))]
    # the dispatch grid: one split against split-K at the rule's split
    # count (at least 2), device time, every sequence at the full table,
    # B.KV = 8 .. 256 at qwen3-0.6b's 8 KV heads
    kv = PAGED_HEADS[0]["KV"]
    jobs += [("paged_decode_attention_splitk", lambda B=B, nb=nb:
              _splitk_job(torch, device, B, nb,
                          max(2, decode_splits(B, kv, nb, n_sm))))
             for B, nb in DECODE_GRID]
    jobs += [("paged_prefill_attention", lambda T=T, pos=pos: _paged_job(
        torch, device, paged_prefill_case, {"T": T, "pos": pos}))
        for T, pos in ((512, 0), (128, 200), (16, 8))]
    # the verify forward's shape: 8 slots of 5 rows at their own positions
    jobs += [("paged_prefill_attention", lambda: _paged_job(
        torch, device, paged_verify_case, {"pos": VERIFY_TIMING_POS}))]
    jobs += [("flash_attention", lambda: _flash_job(
        torch, device, 8, 512, 512, True, None))]
    jobs += [("decode_attention", lambda: _decode_job(torch, device, 544,
                                                      "round"))]
    jobs += [("flash_attention", lambda: _flash_job(
        torch, device, *FLASH_RG_CASES[1], **RG_HEADS))]
    jobs += [("decode_attention", lambda: _decode_job(
        torch, device, *DECODE_RG_CASES[0][:2], **RG_HEADS,
        **DECODE_RG_CASES[0][2]))]
    jobs += [("rglru_scan", lambda: _rglru_job(torch, device,
                                               *RGLRU_CASES[0]))]
    jobs += [("rwkv6_scan", lambda: _rwkv_job(torch, device,
                                              *RWKV_CASES[0]))]
    jobs += [("moe_matmul", lambda a=a: _moe_job(torch, device, *a))
             for a in MOE_TIMING_CASES]
    jobs += _family_timing_jobs(torch, device, n_sm)
    out = {}
    for name, make in jobs:
        kern, plain = w[name]
        k_args, p_args, lib, (bound, by), what, *extra = make()
        others = extra[0] if extra else {}
        n = len(k_args)
        t = {"lib": [], "plain": [], "kern": [], **{o: [] for o in others}}
        if lib:
            t["lib"].append(_time_ms(torch, lib, n))
        t["plain"].append(_time_ms(torch, lambda i: plain(**p_args[i]), n))
        for o, fn in others.items():
            t[o].append(_time_ms(torch, fn, n))
        t["kern"].append(_time_ms(torch, lambda i: kern(**k_args[i]), n))
        t["kern"].append(_time_ms(torch, lambda i: kern(**k_args[i]), n))
        for o, fn in others.items():
            t[o].append(_time_ms(torch, fn, n))
        t["plain"].append(_time_ms(torch, lambda i: plain(**p_args[i]), n))
        lib_note = "none (no single PyTorch call)"
        if lib:
            t["lib"].append(_time_ms(torch, lib, n))
            got = lib(0)
            if name != "moe_matmul":  # SDPA's (B, H, T, hd)
                got = got.transpose(1, 2)
            lib_err = float((got - plain(**p_args[0])).abs().max())
            lib_note = (f"{np.mean(t['lib']):.4f} "
                        f"({'bmm' if name == 'moe_matmul' else 'sdpa'} vs "
                        f"plain max err {lib_err:.2e})")
            del got
        row = {"ms": float(np.mean(t["kern"])),
               "plain_ms": float(np.mean(t["plain"])),
               "library_ms": float(np.mean(t["lib"])) if lib else None,
               "bound_ms": bound, "bound_by": by}
        row.update({f"{o}_ms": float(np.mean(t[o])) for o in others})
        other_note = "".join(f", {o}_ms {np.mean(t[o]):.4f} (runs {t[o]})"
                             for o in others)
        # device time alone (the profiler's kernel durations): where a
        # call's host overhead exceeds its device time, the event times
        # above measure the host; the library call's too
        events = {}
        timed = (("kernel", lambda i: kern(**k_args[i])), *others.items(),
                 *((("library", lib),) if lib else ()))
        for o, fn in timed:
            row[f"{o}_device_ms"], events[o] = _device_ms(torch, fn, n)
        other_note += "".join(f", {o}_device_ms {row[o + '_device_ms']:.4f} "
                              f"(events per kernel of 20 calls {events[o]})"
                              for o, _ in timed)
        other_note += (f" ({bound / row['kernel_device_ms']:.1%} of bound in "
                       "device time)")
        log(f"timing {name} {what}: kernel_ms {row['ms']:.4f} (runs "
            f"{t['kern']}){other_note}, plain_ms {row['plain_ms']:.4f}, "
            f"library_ms {lib_note}, bound_ms {bound:.4f} by {by}, "
            f"{bound / row['ms']:.1%} of bound [{smi}]")
        out.setdefault(name, row)
        del k_args, p_args, lib
        torch.cuda.empty_cache()
    return out


def _family_timing_jobs(torch, device, n_sm):
    """The family paths' kernel shapes (``FAMILY_CASES``): chatglm3's
    paged decode (4 slots, 40 columns, split-K at the rule's count) and
    its 16-token and 512-token chunks at G = 16 (4 query rows per block),
    its b = 4 round's flash; starcoder2's
    windowed flash and dense decode over its 4096-slot ring filled to 528
    and full; qwen2-vl's flash at 1,088 rows and its paged decode over
    128 columns; seamless's encoder and cross flash (non-causal), its
    dense self and cross decode at hd 64; yi's 4-slot paged decode."""
    from repro_torch.kernels.decode_attention import decode_splits

    glm, sc2, vl, sm, yi = (FAMILY_CASES[a]["heads"] for a in (
        "chatglm3-6b", "starcoder2-15b", "qwen2-vl-7b",
        "seamless-m4t-large-v2", "yi-34b"))
    jobs = [("paged_decode_attention_splitk", lambda h=h, nb=nb:
             _splitk_job(torch, device, 4, nb, max(2, decode_splits(
                 4, h["KV"], nb, n_sm)), **h))
            for h, nb in ((glm, 40), (vl, 128), (yi, 40))]
    jobs += [("paged_prefill_attention", lambda T=T, pos=pos: _paged_job(
        torch, device, paged_prefill_case, {"T": T, "pos": pos, **glm}))
        for T, pos in ((16, 8), (512, 0))]
    jobs += [("flash_attention", lambda a=a, h=h: _flash_job(
        torch, device, *a, **h))
        for a, h in (((4, 512, 512, True, None), glm),
                     ((4, 512, 512, True, 4096), sc2),
                     ((2, 1088, 1088, True, None), vl),
                     ((4, 128, 128, False, None), sm),
                     ((4, 512, 128, False, None), sm))]
    jobs += [("decode_attention", lambda a=a, h=h, x=x: _decode_job(
        torch, device, *a, B=4, **h, **x))
        for a, h, x in (((4096, "round"), sc2, {"front": 528}),
                        ((4096, "round"), sc2, {"front": 4096}),
                        ((528, "round"), sm, {}),
                        ((128, "round"), sm, {"front": 128}))]
    return jobs


# ---------------------------------------------------------------- phases 5-8
def _watch_logits(torch, model, bad, attrs):
    """Wrap the model's forwards ``attrs`` so each output's finiteness is
    recorded (as device booleans, read once at the end)."""
    for attr in attrs:
        orig = getattr(model, attr)

        def checked(*args, _orig=orig):
            logits, cache = _orig(*args)
            bad.append(~torch.isfinite(logits).all())
            return logits, cache
        setattr(model, attr, checked)


def _paged_decode_kernel(cfg, n_slots, nb):
    """The paged decode kernel the model's dispatch takes for an engine of
    ``n_slots`` slots and ``nb``-column tables on this card (through the
    split rule the model's paged decode calls)."""
    import torch
    from repro_torch.models import attention

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return "paged_decode_attention_splitk" if attention.decode_splits(
        n_slots, cfg.n_kv_heads, nb, n_sm) > 1 else "paged_decode_attention"


def _want(cfg, path, n_iters=0, n_chunks=0, n_rounds=0, n_tokens=0,
          n_slots=8, nb=40, n_spec=0, n_inline=0):
    """The exact kernel launches of one serving path: per attention layer
    (``attn``/``attn_dense``/``local_attn``) one decode kernel per decode
    iteration or round token and, paged, one chunk kernel per prefill
    chunk where every layer is paged (fused prefill), or one flash launch
    per round. ``n_spec`` of the ``n_iters`` iterations speculated: each
    runs one verify forward instead of a decode, through the paged chunk
    kernel (paged) or plain PyTorch (dense, as the reference has no
    kernel there). Under the paged layout a linear attention layer decodes
    through the unsplit or the split-K paged kernel (as the dispatch
    picks for ``n_slots`` slots and ``nb``-column tables) and a windowed
    one through dense decode over its ring; a hybrid stack's chunks run
    against the staging cache, whose attention is plain PyTorch, as are
    dense chunks. Per recurrent layer one scan per prefill chunk or round
    (decode steps are the one-step formula); per MoE layer three grouped
    GEMMs (gate, up, down) per forward: every decode iteration, chunk,
    round and round token. A frontend model's ``n_inline`` one-shot
    admissions run one flash launch per attention layer each (and no
    chunk). An encoder-decoder round adds one non-causal flash launch per
    encoder layer and one per decoder layer's cross-attention, and each
    round token one dense decode launch per decoder layer's
    cross-attention."""
    from repro_torch.models.transformer import paged_layer_kind

    kinds = cfg.layer_kinds()
    attn = [k for k in kinds if k in ("attn", "attn_dense", "local_attn")]
    M = sum(k != "attn_dense" for k in kinds) if cfg.n_experts else 0
    cross = len(attn) if cfg.enc_dec else 0
    want = {name: 0 for name in REPLACES}
    want["flash_attention"] = len(attn) * n_inline
    if path in ("paged", "dense"):
        want["moe_matmul"] = 3 * M * (n_iters + n_chunks + n_inline)
        seqs = n_chunks + n_inline
    else:
        want["moe_matmul"] = 3 * M * (n_rounds + n_tokens)
        seqs = n_rounds
    n_dec = n_iters - n_spec
    if path == "paged":
        P = sum(paged_layer_kind(cfg, k) for k in attn)
        want[_paged_decode_kernel(cfg, n_slots, nb)] = P * n_dec
        if P == len(kinds):  # fused prefill (and verify) through the table
            want["paged_prefill_attention"] = P * (n_chunks + n_spec)
        want["decode_attention"] = (len(attn) - P) * n_dec
    elif path == "dense":
        want["decode_attention"] = len(attn) * n_dec
    else:  # round
        want["flash_attention"] = (len(attn) + cfg.n_enc_layers * (
            cross > 0) + cross) * n_rounds
        want["decode_attention"] = (len(attn) + cross) * n_tokens
    want["rglru_scan"] = kinds.count("rglru") * seqs
    want["rwkv6_scan"] = kinds.count("rwkv") * seqs
    return want


def phase_e2e(torch, device, cfg, params, smi, kv_layout, n_req=16,
              max_new=32, seed=0, profile=True):
    """Serve ``n_req`` seeded requests (prompts 4..500 tokens) through the
    continuous engine with ``kv_layout`` at full width until drained;
    check every request and the launch counts, then (with ``profile``)
    profile a prefill step and three decode steps. Returns (the kernels'
    launches, the end-to-end numbers)."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout=kv_layout, token_budget=512,
                                   device=device, params=params)
    torch.cuda.synchronize()
    layouts = sorted({str({k: tuple(t.shape) for k, t in c.items()})
                      for c in eng.cache})
    log(f"e2e {cfg.name} {kv_layout}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"engine built in {time.perf_counter() - t0:.1f} s, layer caches "
        f"{', '.join(layouts)} over {len(eng.cache)} layers")
    rng = np.random.default_rng(seed)
    eng.run([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
            max_new_tokens=2)  # warm-up: cuBLAS handles, kernel libraries
    lens = rng.permutation(np.linspace(4, 500, n_req).round().astype(int))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    bad = []
    _watch_logits(torch, eng.model, bad, ("decode_step", "prefill_chunk"))
    it0, ch0, tok0 = eng.n_iters, eng.n_prefill_chunks, \
        eng.n_prefill_chunk_tokens
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    results, decode_ms, prefill_s = [], [], 0.0
    t0 = time.perf_counter()
    while eng.waiting or eng.active_slots:
        before = eng.n_prefill_chunk_tokens
        ts = time.perf_counter()
        results += eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        if eng.n_prefill_chunk_tokens == before:
            decode_ms.append(dt * 1e3)
        else:
            prefill_s += dt
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    n_pre = eng.n_prefill_chunk_tokens - tok0
    if len(results) != n_req or any(len(r.tokens) != max_new
                                    for r in results):
        fail(f"e2e {cfg.name} {kv_layout}: {len(results)} of {n_req} requests "
             f"finished, token counts {[len(r.tokens) for r in results]}")
    if bool(torch.stack(bad).any()):
        fail(f"e2e {cfg.name} {kv_layout}: non-finite logits")
    want = _want(cfg, kv_layout, n_iters=n_iters, n_chunks=n_chunks)
    if launches != want:
        fail(f"e2e {cfg.name} {kv_layout}: launches {launches} != {want} ("
             f"{n_iters} decode iterations, {n_chunks} prefill chunks)")
    gen = sum(len(r.tokens) for r in results)
    results.sort(key=lambda r: r.request_id)
    res = {"tokens": [r.tokens for r in results],
           "tokens_per_s": gen / wall,
           "p50": float(np.percentile(decode_ms, 50)),
           "p99": float(np.percentile(decode_ms, 99)),
           "prefill_tokens_per_s": n_pre / max(prefill_s, 1e-9)}
    log(f"e2e {cfg.name} {kv_layout}: {n_req} requests (prompts {int(lens.min())}.."
        f"{int(lens.max())} tokens), {gen} generated tokens, {n_iters} "
        f"decode iterations, {n_chunks} prefill chunks ({n_pre} tokens), "
        f"wall {wall:.3f} s, {res['tokens_per_s']:.1f} generated tokens/s, "
        f"decode-only iteration ms p50 {res['p50']:.3f} p99 "
        f"{res['p99']:.3f} (n={len(decode_ms)}), prefill "
        f"{res['prefill_tokens_per_s']:.0f} tokens/s over steps with "
        f"prefill ({prefill_s:.3f} s, their decode included), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    log(f"e2e {cfg.name} {kv_layout}: launches {launches} == {want}")
    if profile:
        phase_profile(torch, eng, rng, res["p50"], smi,
                      f"{cfg.name} {kv_layout}")
    del eng
    torch.cuda.empty_cache()
    return launches, res


def _profiled(torch, fn, counts=None):
    """Run ``fn`` under torch.profiler; returns (wall s, device busy ms,
    device kernels launched, {kernel name: device ms}), and fills
    ``counts`` (if given) with {kernel name: events recorded}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return wall, sum(by_name.values()), n, by_name


def _report_profile(report, smi, label):
    if not all(r[3] > 0 for r in report):
        fail(f"profile {label}: torch.profiler recorded no device time")
    for what, steps, wall, busy, n, names in report:
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        log(f"profile {label} {what}: device busy {busy / steps:.3f} "
            f"ms/step, {n // steps} kernels/step, profiled wall "
            f"{wall * 1e3 / steps:.3f} ms/step [{smi}]")
        for name, ms in top:
            log(f"  {ms / steps:8.3f} ms/step {ms / busy:6.1%}  {name[:90]}")
        moe_ms = sum(ms for name, ms in names.items()
                     if "moe_matmul_kernel" in name)
        if moe_ms:
            log(f"  moe_matmul: {moe_ms / steps:.3f} ms/step, "
                f"{moe_ms / busy:.1%} of device busy")


#: profiler name fragments of the paged decode kernels (the split-K
#: combine included), of the paged prefill kernel, and of dense decode
#: (its splits' combine included; a dense engine launches no paged
#: kernel)
DECODE_KERNELS = ("paged_decode_kernel", "splitk_combine_kernel")
PREFILL_KERNELS = ("paged_prefill_kernel",)
DENSE_DECODE_KERNELS = ("dense_decode_kernel", "splitk_combine_kernel")


def _kernel_ms(names, fragments):
    """Device ms of the profiled kernels whose name holds a fragment."""
    return sum(ms for n, ms in names.items()
               if any(f in n for f in fragments))


def phase_profile(torch, eng, rng, decode_p50_ms, smi, label):
    """Where an iteration's time goes: one prefill-heavy step (8 prompts
    of 30..400 tokens admitted at once under the 512-token budget), three
    decode-only steps and, paged, the step of one 512-token chunk (a
    500-token prompt alone), each under torch.profiler. Device busy time
    is the sum of kernel durations; the decode steps' busy share is taken
    against the unprofiled decode p50 of the drain (the profiler slows
    the host)."""
    for n in (100, 200, 300, 400, 30, 60, 90, 120):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=16)
    wall, busy, n, names = _profiled(torch, eng.step)
    report = [("prefill step", 1, wall, busy, n, names)]
    while eng.prefill_backlog_tokens:
        eng.step()

    def three():
        for _ in range(3):
            eng.step()
    wall, busy, n, names = _profiled(torch, three)
    report.append(("decode-only step", 3, wall, busy, n, names))
    if eng.kv_layout == "paged":
        while eng.waiting or eng.active_slots:
            eng.step()
        eng.submit(rng.integers(1, eng.cfg.vocab_size, 500).astype(
            np.int32), max_new_tokens=2)
        chunks = eng.n_prefill_chunk_tokens
        wall, busy, n, names = _profiled(torch, eng.step)
        chunks = eng.n_prefill_chunk_tokens - chunks
        report.append((f"one-chunk step ({chunks} prompt tokens)", 1, wall,
                       busy, n, names))
    _report_profile(report, smi, label)
    busy = report[1][3] / 3
    log(f"profile {label}: decode-only device busy {busy:.3f} ms of the "
        f"unprofiled p50 {decode_p50_ms:.3f} ms per iteration: idle share "
        f"{1 - busy / decode_p50_ms:.1%}")
    if eng.kv_layout == "paged":
        dec = _kernel_ms(report[1][5], DECODE_KERNELS) / 3
        pre = _kernel_ms(report[2][5], PREFILL_KERNELS)
        log(f"profile {label}: paged decode kernels {dec:.3f} ms per "
            f"decode-only iteration ({dec / busy:.1%} of device busy); "
            f"paged prefill kernel {pre:.3f} ms in the one-chunk step of "
            f"{report[2][3]:.3f} ms device busy [{smi}]")
    else:
        dec = _kernel_ms(report[1][5], DENSE_DECODE_KERNELS) / 3
        log(f"profile {label}: dense decode kernels {dec:.3f} ms per "
            f"decode-only iteration ({dec / busy:.1%} of device busy) "
            f"[{smi}]")


def phase_split_rule(torch, device, cfg, params, smi, n_slots=8, turns=8,
                     per_turn=5, seed=3):
    """The decode iteration of ``n_slots`` resident sequences at full
    width over 40-column tables (max_seq 640, the drains' engine) under
    the measured split rule and with one split, in turns of ``per_turn``
    decode-only iterations ordered A B B A A B ..., so that the host's
    drift cancels: wall ms per iteration (host and device), the mean
    difference of paired turns with its standard error, then the device
    busy of three profiled iterations under each. Every slot stays
    resident and decoding throughout; the launches are checked against
    the kernel each rule dispatches. Returns the paired difference (ms,
    split rule minus one split)."""
    from repro_torch.models import attention
    from repro_torch.serving.engine import ContinuousBatchingEngine

    measured = attention.decode_splits
    rules = {"the split rule": measured,
             "one split": lambda B, KV, nb, n_sm: 1}
    names = list(rules)
    steps = turns * per_turn + 3 * len(rules)
    eng = ContinuousBatchingEngine(cfg, max_slots=n_slots, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   device=device, params=params)
    nb = eng.block_tables.shape[1]
    rng = np.random.default_rng(seed)
    # prompts of 50..250 tokens (buckets of at most 256) leave room for
    # every step in 640 slots
    for n in np.linspace(50, 250, n_slots).round().astype(int):
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=steps + 16)
    while eng.waiting or eng.prefill_backlog_tokens:
        eng.step()
    A = sum(k in ("attn", "attn_dense", "local_attn")
            for k in cfg.layer_kinds())
    walls = {n: [] for n in names}
    busy = {}
    want = {n: 0 for n in REPLACES}
    pre0 = eng.n_prefill_chunk_tokens
    reset_launches()
    try:
        for t in range(turns):
            name = names[(t + 1) // 2 % 2]
            attention.decode_splits = rules[name]
            want[_paged_decode_kernel(cfg, n_slots, nb)] += A * per_turn
            for _ in range(per_turn):
                ts = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - ts) * 1e3)
        for name in names:
            attention.decode_splits = rules[name]
            want[_paged_decode_kernel(cfg, n_slots, nb)] += A * 3
            _, b, _, by_name = _profiled(
                torch, lambda: [eng.step() for _ in range(3)])
            busy[name] = (b / 3, _kernel_ms(by_name, DECODE_KERNELS) / 3)
    finally:
        attention.decode_splits = measured
    got = read_launches()
    if (got != want or eng.n_prefill_chunk_tokens != pre0
            or len(eng.active_slots) != n_slots):
        fail(f"split rule {cfg.name} {n_slots} slots: launches {got} != "
             f"{want}, or a step prefilled or a slot emptied "
             f"({len(eng.active_slots)} resident)")
    what = f"split rule {cfg.name} {n_slots} slots ({nb} columns)"
    for name in names:
        ms = np.asarray(walls[name])
        log(f"{what}, {name}: decode-only iteration wall ms median "
            f"{np.median(ms):.3f} mean {ms.mean():.3f} p90 "
            f"{np.percentile(ms, 90):.3f} (n={len(ms)}); device busy "
            f"{busy[name][0]:.3f} ms per iteration, paged decode kernels "
            f"{busy[name][1]:.3f} ms [{smi}]")
    # the k-th turn of each rule are neighbours in time (A B, B A, ...)
    d = np.asarray(walls[names[0]]).reshape(-1, per_turn).mean(1) \
        - np.asarray(walls[names[1]]).reshape(-1, per_turn).mean(1)
    se = d.std(ddof=1) / np.sqrt(len(d))
    log(f"{what}: {names[0]} ({_paged_decode_kernel(cfg, n_slots, nb)}) "
        f"minus one split, paired turns: {d.mean():+.3f} ms per iteration "
        f"(standard error {se:.3f}, {len(d)} pairs); launches {got} == "
        f"{want}")
    del eng
    torch.cuda.empty_cache()
    return float(d.mean()), float(se)


def phase_serve(torch, device, cfg, kv_layout, max_slots=4):
    """The normal entry point, serve_continuous, at full width with
    ``max_slots`` slots. Returns the kernels' launches."""
    from repro_torch.launch.engine_serve import serve_continuous

    reset_launches()
    stats = serve_continuous(cfg=cfg, kv_layout=kv_layout, duration_s=3.0,
                             max_slots=max_slots, device=device)
    got = read_launches()
    # serve_continuous: max_seq 128 (8 blocks of 16)
    want = _want(cfg, kv_layout, n_iters=int(stats["n_iters"]),
                 n_chunks=int(stats["n_prefill_chunks"]), n_slots=max_slots,
                 nb=8)
    if stats["served"] < 1 or got != want:
        fail(f"serve_continuous {cfg.name} {kv_layout} ({max_slots} slots): "
             f"served {stats['served']}, launches {got} != {want}")
    log(f"serve_continuous {cfg.name} {kv_layout} ({max_slots} slots): "
        f"{stats['served']:.0f} requests in 3 s, launches {got} == {want}")
    torch.cuda.empty_cache()
    return got


#: batch sizes of the round-mode phase's rounds (the SAC action set)
ROUND_SIZES = (1, 2, 4, 8, 8, 4)


def phase_round(torch, device, cfg, params, smi, max_new=32, seed=0):
    """Round mode at full width: ``InferenceEngine.generate`` over rounds
    of ``ROUND_SIZES`` seeded prompts (4..500 tokens), ``max_new`` tokens
    each. Checks the launch counts (one flash launch per layer and round,
    one decode launch per layer and token) and finite logits, then
    profiles one round. Returns (launches, numbers)."""
    from repro_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(cfg, device=device, params=params)
    rng = np.random.default_rng(seed + 7)
    eng.generate([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
                 max_new_tokens=2)  # warm-up
    bad = []
    _watch_logits(torch, eng.model, bad, ("prefill", "decode_step"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows, n_tok, total_ms = [], 0, 0.0
    for b in ROUND_SIZES:
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in rng.integers(4, 501, b)]
        res = eng.generate(prompts, max_new_tokens=max_new)
        if res.tokens.shape != (b, max_new):
            fail(f"round: tokens {res.tokens.shape} for b={b}")
        S = max(len(p) for p in prompts)
        rows.append((b, S, res))
        n_tok += b * max_new
        total_ms += res.total_ms
    launches = read_launches()
    n = len(ROUND_SIZES)
    want = _want(cfg, "round", n_rounds=n, n_tokens=max_new * n)
    if launches != want:
        fail(f"round: launches {launches} != {want}")
    if bool(torch.stack(bad).any()):
        fail("round: non-finite logits")
    for b, S, res in rows:
        log(f"round {cfg.name} b={b} (longest prompt {S}): prefill {res.prefill_ms:.1f}"
            f" ms, decode {res.decode_ms / max_new:.2f} ms/token, "
            f"{b * max_new / res.total_ms * 1e3:.1f} generated tokens/s "
            f"[{smi}]")
    out = {"tokens_per_s": n_tok / total_ms * 1e3,
           "prefill_ms": float(np.mean([r.prefill_ms for _, _, r in rows])),
           "decode_ms_per_token": float(np.mean(
               [r.decode_ms / max_new for _, _, r in rows]))}
    log(f"round {cfg.name}: {n} rounds, {n_tok} generated tokens in "
        f"{total_ms / 1e3:.3f} s: {out['tokens_per_s']:.1f} generated "
        f"tokens/s, mean prefill {out['prefill_ms']:.1f} ms/round, mean "
        f"decode {out['decode_ms_per_token']:.2f} ms/token, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    log(f"round: launches {launches} == {want}")
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (100, 200, 300, 400, 30, 60, 90, 120)]
    wall, busy, nk, names = _profiled(
        torch, lambda: eng.generate(prompts, max_new_tokens=4))
    _report_profile([("round b=8 S=512 +4 tokens", 1, wall, busy, nk,
                      names)], smi, f"round {cfg.name}")
    del eng
    torch.cuda.empty_cache()
    return launches, out


def phase_serve_round(torch, device, cfg, smi):
    """The normal entry point, serve_round, at full width: the SAC agent
    picks each round's batch size and learns from its utility."""
    from repro_torch.launch.engine_serve import serve_round

    reset_launches()
    # 14 s hold 38 to 69 rounds (host speed varies), past the agent's
    # 32-round mini-batch (10 s held 27 on a slow host, PR 23)
    stats = serve_round(cfg=cfg, duration_s=14.0, device=device)
    got = read_launches()
    r = int(stats["rounds"])
    # the entry point's warm-up round decodes 2 tokens, each round 4
    want = _want(cfg, "round", n_rounds=r + 1, n_tokens=4 * r + 2)
    if stats["served"] < 1 or stats["sac_updates"] < 1 or got != want:
        fail(f"serve_round: {stats}, launches {got} != {want}")
    log(f"serve_round: {stats['served']:.0f} requests in {r} rounds, "
        f"{stats['sac_updates']:.0f} SAC updates; SAC act "
        f"{stats['sac_act_ms']:.3f} ms/round, update "
        f"{stats['sac_update_ms']:.3f} ms [{smi}]")
    torch.cuda.empty_cache()
    return stats


# ---------------------------------------------------------------- phase 9
def _margin(torch, cfg, params, seq, a, b):
    """|logit[a] - logit[b]| of the model on ``params``' device after the
    token sequence ``seq`` (padded prompt and emitted tokens), in one
    prefill."""
    from repro_torch.models import build_model

    dev = next(_leaves(params)).device
    batch = {"tokens": torch.from_numpy(np.asarray(seq, np.int32)[None]).to(
        dev)}
    if cfg.frontend is not None:  # the engines' zero frontend/frame embeds
        F = max(8, len(seq) // 4) if cfg.enc_dec else cfg.frontend_tokens
        batch["frontend_embeds"] = torch.zeros((1, F, cfg.d_model),
                                               device=dev)
    logits, _ = build_model(cfg).prefill(params, batch)
    return float((logits[0, -1, a] - logits[0, -1, b]).abs())


def _padded(prompt, S):
    return np.concatenate([np.zeros(S - len(prompt), np.int32), prompt])


class _RouterWatch:
    """While active, wraps ``repro_torch.models.moe.moe_apply`` (which the
    trunk calls through its module) to record each MoE call's
    ``drop_frac`` and the smallest gap between neighbouring ranked router
    probs among each row's top k + 1: the routing decisions a rounding
    difference between card and CPU could flip. Kept as device tensors
    and read once."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe = torch, moe
        self.drops, self.gaps = [], []

    def __enter__(self):
        torch, orig = self.torch, self.moe.moe_apply
        self.orig = orig

        def watched(p, x, cfg):
            y, aux = orig(p, x, cfg)
            probs = torch.softmax(
                (x.reshape(-1, x.shape[-1]) @ p["router"]).float(), dim=-1)
            top = torch.topk(probs, min(cfg.top_k + 1, cfg.n_experts),
                             dim=-1).values
            if top.shape[1] > 1:
                self.gaps.append((top[:, :-1] - top[:, 1:]).min())
            self.drops.append(aux["drop_frac"])
            return y, aux
        self.moe.moe_apply = watched
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.orig

    def min_gap(self) -> float:
        return float(self.torch.stack(self.gaps).min()) if self.gaps \
            else float("inf")

    def max_drop(self) -> float:
        return float(self.torch.stack(self.drops).max()) if self.drops \
            else 0.0


def _compare(torch, cfg, params, label, prompts, pads, card, cpu,
             router_gap=float("inf")):
    """Identical greedy streams, or a first divergence at a tie: a logit
    margin below 1e-5 on the CPU model (one prefill of the sequence), or,
    in an MoE model, a routing near-tie: two neighbouring ranked router
    probs (top k + 1) within 1e-5 somewhere in the CPU run (``router_gap``;
    under capacity drops the one-shot prefill's N is not the engine's, so
    this is the check that applies). Returns tokens compared."""
    n_tok = 0
    for p, S, g, c in zip(prompts, pads, card, cpu):
        g, c = np.asarray(g), np.asarray(c)
        n_tok += len(c)
        if np.array_equal(g, c):
            continue
        k = int(np.argmax(g != c))
        m = _margin(torch, cfg, params,
                    np.concatenate([_padded(p, S), c[:k]]), int(c[k]),
                    int(g[k]))
        log(f"parity {label}: diverges at token {k} (cpu {c[k]}, card "
            f"{g[k]}), logit margin {m:.3e}, smallest router gap "
            f"{router_gap:.3e}")
        if not (m < 1e-5 or router_gap < 1e-5):
            fail(f"parity {label}: card and CPU tokens differ beyond a tie "
                 f"(margin {m:.3e}, router gap {router_gap:.3e})")
    return n_tok


def phase_parity(torch, device, cfg, layouts=("paged", "dense"), n_req=8,
                 max_new=16, seed=0, need_drops=False):
    """Same weights, same requests: on the card (kernels) and on the CPU
    (plain versions), the continuous engine under each of ``layouts``
    and the round engine must emit identical greedy tokens; a divergence
    counts as a tie only below a logit margin (or, MoE, a router gap) of
    1e-5. ``need_drops``: every path must drop MoE entries on the card."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import (SEQ_BUCKETS,
                                            ContinuousBatchingEngine,
                                            InferenceEngine, _bucket)

    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(3, 100, n_req).round().astype(int)]
    own = [_bucket(len(p), buckets=SEQ_BUCKETS) for p in prompts]
    S = _bucket(max(len(p) for p in prompts), buckets=SEQ_BUCKETS)

    def serve(path, dev):
        if path == "round":
            return InferenceEngine(cfg, device=dev, params=params).generate(
                prompts, max_new_tokens=max_new).tokens
        eng = ContinuousBatchingEngine(cfg, max_slots=4, max_seq=192,
                                       kv_layout=path, token_budget=64,
                                       device=dev, params=params)
        return [r.tokens for r in eng.run(prompts, max_new_tokens=max_new)]

    for path in (*layouts, "round"):
        runs, watch = {}, {}
        for dev in (device, torch.device("cpu")):
            with _RouterWatch(torch) as watch[dev.type]:
                runs[dev.type] = serve(path, dev)
        gap = watch["cpu"].min_gap()
        n_tok = _compare(torch, cfg, params, path, prompts,
                         [S] * n_req if path == "round" else own,
                         runs[device.type], runs["cpu"], gap)
        what = (f"one round of {n_req} prompts" if path == "round"
                else f"{n_req} requests")
        moe = ""
        if cfg.n_experts:
            drop = watch[device.type].max_drop()
            moe = (f"; capacity factor {cfg.capacity_factor}, largest "
                   f"drop_frac on the card {drop:.4f} (CPU "
                   f"{watch['cpu'].max_drop():.4f}), smallest router gap "
                   f"{gap:.3e}")
            if need_drops and not drop > 0:
                fail(f"parity {cfg.name} {path}: no MoE entry dropped on "
                     "the card at capacity factor "
                     f"{cfg.capacity_factor}")
        log(f"parity {cfg.name} {path}: {what}, {n_tok} greedy tokens "
            f"identical on card and CPU{moe}")
    log(f"parity: {cfg.name} reduced (L={cfg.n_layers}, d={cfg.d_model}, "
        f"kinds {sorted(set(cfg.layer_kinds()))}) passed on "
        f"{len(layouts) + 1} paths")


#: the frontend families held card vs CPU on random frontend embeddings
#: (the engines feed zeros, which zero seamless's encoder output and cross
#: K/V): seamless's encoder, cross K/V and the step's cross branch, and
#: qwen2-vl's frontend projection under M-RoPE grid positions
FRONTEND_PARITY = ("seamless-m4t-large-v2", "qwen2-vl-7b")


def phase_frontend_parity(torch, device, B=4, S=100, n_steps=4, seed=0):
    """Each reduced config of ``FRONTEND_PARITY`` on the card and on the
    CPU with the same params, seeded tokens and seeded standard-normal
    frontend (or frame) embeddings: ``Model.prefill``, then ``n_steps``
    decode steps over the padded caches, both fed the CPU's greedy tokens.
    Prefill and step logits and every prefill cache tensor (``ck``/``cv``
    included) within ``TOL`` of the CPU's; the card's launches exactly
    ``_want``'s for one round of ``n_steps`` tokens."""
    from repro_torch.config import get_reduced_config
    from repro_torch.device import to_device
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params, pad_cache

    for arch in FRONTEND_PARITY:
        cfg = get_reduced_config(arch)
        model = build_model(cfg)
        p_cpu = init_params(cfg, seed=seed, device="cpu")
        p_dev = to_device(p_cpu, device)
        rng = np.random.default_rng(seed + 3)
        F = max(8, S // 4) if cfg.enc_dec else cfg.frontend_tokens
        cpu = {"tokens": torch.from_numpy(rng.integers(
                   1, cfg.vocab_size, (B, S)).astype(np.int32)),
               "frontend_embeds": torch.from_numpy(rng.standard_normal(
                   (B, F, cfg.d_model)).astype(np.float32))}
        label = f"frontend parity {arch}"
        reset_launches()
        got, g_cache = model.prefill(p_dev, {k: v.to(device)
                                             for k, v in cpu.items()})
        want, w_cache = model.prefill(p_cpu, cpu)
        _check(torch, label, got.cpu(), want, f"prefill logits B={B} "
               f"S={S} frontend {F}", vs="the CPU")
        for i, (gl, wl) in enumerate(zip(g_cache, w_cache)):
            for key in sorted(wl):
                if torch.is_tensor(wl[key]) and wl[key].is_floating_point():
                    _check(torch, label, gl[key].cpu(), wl[key],
                           f"layer {i} cache {key} {tuple(wl[key].shape)}",
                           vs="the CPU")
        g_cache = pad_cache(cfg, g_cache, n_steps)
        w_cache = pad_cache(cfg, w_cache, n_steps)
        pos = torch.full((B,), S if cfg.enc_dec else F + S,
                         dtype=torch.int32)
        for t in range(n_steps):
            tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
            got, g_cache = model.decode_step(p_dev, g_cache, {
                "tokens": tok.to(device), "pos": pos.to(device)})
            want, w_cache = model.decode_step(p_cpu, w_cache, {
                "tokens": tok, "pos": pos})
            _check(torch, label, got.cpu(), want, f"decode step {t} at "
                   f"position {int(pos[0])}", vs="the CPU")
            pos = pos + 1
        launches = read_launches()
        need = _want(cfg, "round", n_rounds=1, n_tokens=n_steps)
        if launches != need:
            fail(f"{label}: launches {launches} != {need}")
        log(f"{label}: reduced (L={cfg.n_layers} +{cfg.n_enc_layers} "
            f"encoder, d={cfg.d_model}) prefill and {n_steps} decode steps "
            f"on random frontend embeddings agree with the CPU; launches "
            f"{launches}")


# ---------------------------------------------------------------- pool
#: the paged pool's workload: qwen3-0.6b at full width behind the
#: instance pool, prompts of a 500-token shared system prompt plus an
#: 8-token tail (max_seq 576, 36-column tables), 32 new tokens each at
#: 1 request/s under a 10 s SLO. The pool's admission rejects a request
#: whose predicted service time, which follows the host's speed, exceeds
#: its slack: at 1.5 requests/s and a 5 s SLO it served 1 to 5 of 12 to 16
#: requests, and none on a slow host, which failed the phase. This phase
#: drives the path and checks its launches;
#: `python -m repro_torch.launch.pool_sweep` measures the pool
POOL_PAGED = dict(shared_prefix_tokens=500, max_instances=4, max_slots=4,
                  max_new_tokens=32, rps=1.0, slo_ms=10000.0,
                  kv_block_budget=576, duration_s=10.0)
#: the dense pool: the reference CLI's own pair of heterogeneous models at
#: its 12 requests/s in all
POOL_DENSE = ("qwen3-0.6b", "recurrentgemma-2b")


class _PoolProbe:
    """While active, wraps ``ModelInstancePool.step`` to profile one step
    in which every busy instance only decodes, once the pool holds ten
    contention samples (its own pure-decode step times) at that many busy
    instances. ``pool`` is the pool serve_pool built (its ``pool_out``)."""

    def __init__(self, torch, profile):
        self.torch = torch
        self.want_profile = profile
        self.kept = []
        self.profile = None
        self.profiled = None    # the profiled step's contention sample

    @property
    def pool(self):
        return self.kept[0]

    def __enter__(self):
        from repro_torch.serving.runtime import ModelInstancePool

        torch, probe = self.torch, self
        self.orig = step = ModelInstancePool.step
        if not self.want_profile:
            return self

        def profiled_once(pool):
            if probe.profile is not None:
                return step(pool)
            busy = [i for i in pool.live()
                    if i.engine.active_slots or i.engine.waiting]
            if not busy or any(pool.queues.values()) or any(
                    i.engine.waiting or i.engine.prefill_backlog_tokens
                    for i in busy) or sum(
                    o == len(busy) for o, _ in pool.contention_samples) < 10:
                return step(pool)
            last = pool.contention_samples[-1]
            out = []
            prof = _profiled(torch, lambda: out.append(step(pool)))
            probe.profile = (len(busy), sum(i.n_resident for i in busy),
                             *prof)
            if pool.contention_samples[-1] is not last:
                probe.profiled = pool.contention_samples[-1]
            return out[0]

        ModelInstancePool.step = profiled_once
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.runtime import ModelInstancePool

        ModelInstancePool.step = self.orig

    def engines(self):
        """(config, layout, slots, table columns) -> [decode iterations,
        prefill chunks], over every engine the pool built: the live
        instances' and the retired ones' (their engines' final stats)."""
        pool = self.pool
        nb = {}
        for m, lst in pool.instances.items():
            for i in lst:
                if pool.kv_layout == "paged":
                    nb[m] = i.engine.block_tables.shape[1]
        tally = {}
        for inst in [i for lst in pool.instances.values() for i in lst] \
                + pool.retired:
            st = inst.engine.stats() if inst.engine is not None \
                else inst.engine_stats
            if pool.kv_layout == "paged" and inst.model not in nb:
                fail(f"pool: no live {inst.model} engine gives the table "
                     f"width")
            key = (inst.model, pool.kv_layout, int(st["n_slots"]),
                   nb.get(inst.model, 0))
            t = tally.setdefault(key, [0, 0])
            t[0] += int(st["n_iters"])
            t[1] += int(st["n_prefill_chunks"])
        return tally

    def want(self, tally):
        """The launch formula over the pool's engines (``_want`` per
        engine shape, the paged decode kernel as the dispatch picks it for
        the engine's slots and table width)."""
        want = {name: 0 for name in REPLACES}
        for (m, layout, slots, nb), (iters, chunks) in tally.items():
            got = _want(self.pool.configs[m], layout, n_iters=iters,
                        n_chunks=chunks, n_slots=slots, nb=nb)
            for k, n in got.items():
                want[k] += n
        return want


def _pool_run(torch, device, smi, label, profile=False, **kw):
    """serve_pool under a _PoolProbe; checks the launch formula exactly
    and that every model served. Returns (launches, probe, report)."""
    from repro_torch.launch.engine_serve import serve_pool

    reset_launches()
    t0 = time.perf_counter()
    with _PoolProbe(torch, profile) as probe:
        report = serve_pool(device=device, pool_out=probe.kept, **kw)
    wall = time.perf_counter() - t0
    tally = probe.engines()
    got, want = read_launches(), probe.want(tally)
    log(f"pool {label}: engines {tally} ((config, layout, slots, table "
        f"columns) -> [decode iterations, prefill chunks])")
    if got != want:
        fail(f"pool {label}: launches {got} != formula {want}")
    log(f"pool {label}: launches {got} == formula {want}")
    for m, row in report.items():
        if row["served"] < 1:
            fail(f"pool {label}: {m} served nothing: {row}")
        log(f"pool {label} {m} at {kw['rps']} requests/s: served "
            f"{row['served']:.0f}, rejected {row['rejected']:.0f}, SLO "
            f"attainment {row['slo_attainment']:.3f} (SLO "
            f"{kw['slo_ms']:.0f} ms), mean latency "
            f"{row['mean_latency_ms']:.1f} ms, utility "
            f"{row['mean_utility']:.3f}, m_c {row['m_c']:.0f}, "
            f"{row['generated_tokens'] / kw['duration_s']:.1f} generated "
            f"tokens/s over the {kw['duration_s']:.0f} s window [{smi}]")
    log(f"pool {label}: {wall:.1f} s with build, warm-up and teardown")
    return got, probe, report


def phase_pool(torch, device, smi):
    """The multi-model instance pool at full width through its entry
    point, serve_pool, with the PoolScheduler deciding (b, m_c): (a) the
    paged pool of qwen3-0.6b, whose instances decode 4 slots of 36-column
    tables through split-K, with the launch formula checked exactly and
    one decode-only pool step profiled for its idle share; (b) the dense
    pool of qwen3-0.6b and recurrentgemma-2b. Returns the summed
    launches."""
    from repro_torch.config import get_config

    full = get_config(FULL)
    launches = {name: 0 for name in REPLACES}
    got, probe, _ = _pool_run(torch, device, smi, "paged", profile=True,
                              models=[FULL], cfgs={FULL: full},
                              kv_layout="paged", **POOL_PAGED)
    # max_seq 576: 36 table columns of 16
    kern = _paged_decode_kernel(full, POOL_PAGED["max_slots"], 36)
    if not got[kern]:
        fail(f"pool paged: the instances' decode never launched the "
             f"dispatched {kern}")
    log(f"pool paged: paged decode launches (dispatched: {kern}): split-K "
        f"{got['paged_decode_attention_splitk']}, one split "
        f"{got['paged_decode_attention']}")
    for name, n in got.items():
        launches[name] += n
    if probe.profile is None:
        fail("pool paged: no decode-only pool step was profiled")
    n_busy, resident, wall, busy, nk, names = probe.profile
    walls = [smp[1] for smp in probe.pool.contention_samples
             if smp[0] == n_busy and smp is not probe.profiled]
    p50 = float(np.percentile(walls, 50))
    _report_profile([(f"decode-only pool step ({n_busy} busy instances, "
                      f"{resident} resident sequences)", 1, wall, busy, nk,
                      names)], smi, "pool paged")
    dec_ms = _kernel_ms(names, DECODE_KERNELS)
    log(f"pool paged: decode-only step device busy {busy:.3f} ms of the "
        f"pool's unprofiled p50 {p50:.3f} ms over {len(walls)} such steps: "
        f"idle share {1 - busy / p50:.1%}; paged decode (with the split-K "
        f"combine) {dec_ms:.3f} ms [{smi}]")
    torch.cuda.empty_cache()
    got, _, _ = _pool_run(torch, device, smi, "dense",
                          models=list(POOL_DENSE),
                          cfgs={m: get_config(m) for m in POOL_DENSE},
                          kv_layout="dense", duration_s=10.0, rps=12.0,
                          slo_ms=2000.0, max_new_tokens=4)
    for name, n in got.items():
        launches[name] += n
    torch.cuda.empty_cache()
    return launches


def phase_pool_parity(torch, device, cfg, n_req=8, max_new=16, seed=0):
    """The pool on the card against the pool on the CPU at reduced width:
    the same weights (drawn on the CPU), two instances, the same submit
    schedule at one frozen pool clock and SLOs far past it, no scheduler.
    Both layouts; the instance of every request and its greedy tokens
    must match (a divergence counts as a tie only below a logit margin of
    1e-5), and the paged pool's decode must launch the kernel the
    dispatch picks for its 4 slots and 12 columns."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import SEQ_BUCKETS, _bucket
    from repro_torch.serving.runtime import ModelInstancePool

    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(3, 100, n_req).round().astype(int)]
    own = [_bucket(len(p), buckets=SEQ_BUCKETS) for p in prompts]

    def serve(layout, dev):
        pool = ModelInstancePool({cfg.name: cfg}, max_instances=2,
                                 max_slots=4, max_seq=192, seed=seed,
                                 kv_layout=layout, device=dev)
        pool.now = lambda: 0.0
        pool.load_params(cfg.name, params)
        pool.scale_to(cfg.name, 2)
        for p in prompts:
            pool.submit(cfg.name, p, slo_ms=1e9, max_new_tokens=max_new,
                        submit_s=0.0)
        by_id = {r.request_id: r for r in pool.run_until_drained()}
        return ([by_id[i].tokens for i in range(n_req)],
                list(pool.admission_log))

    kern = _paged_decode_kernel(cfg, 4, 12)  # max_seq 192: 12 columns
    for layout in ("paged", "dense"):
        reset_launches()
        card, card_log = serve(layout, device)
        n_dec = read_launches()[kern]
        cpu, cpu_log = serve(layout, torch.device("cpu"))
        if card_log != cpu_log or len({i for _, i in cpu_log}) != 2:
            fail(f"pool parity {layout}: instance assignment differs: card "
                 f"{card_log}, cpu {cpu_log}")
        n_tok = _compare(torch, cfg, params, f"pool {layout}", prompts, own,
                         card, cpu)
        if layout == "paged" and not n_dec:
            fail(f"pool parity paged: no decode step launched {kern}")
        log(f"pool parity {cfg.name} {layout}: {n_req} requests over 2 "
            f"instances, {n_tok} greedy tokens and every assignment "
            f"identical on card and CPU ({kern} launches on the card: "
            f"{n_dec})")


# ---------------------------------------------------------------- online
#: relative tolerance a resumed (re-prefilled) stream may differ from its
#: uninterrupted run at: only a first divergence at a logit margin below
#: this, on the card's own model, counts as a tie (phase_parity's rule)
TIE_MARGIN = 1e-5


def _hold_tie(torch, cfg, params, label, prompt, want, got):
    """``got`` equals ``want``, or first differs at a near-tie: the logit
    margin of the two tokens after the padded prompt and the common
    prefix, on the card's model (one prefill), below ``TIE_MARGIN``.
    Returns the margin (None when equal)."""
    from repro_torch.serving.engine import SEQ_BUCKETS, _bucket

    want, got = np.asarray(want), np.asarray(got)
    if len(want) != len(got):
        fail(f"{label}: {len(got)} tokens where the uninterrupted run "
             f"has {len(want)}")
    if np.array_equal(want, got):
        return None
    k = int(np.argmax(want != got))
    S = _bucket(len(prompt), buckets=SEQ_BUCKETS)
    m = _margin(torch, cfg, params,
                np.concatenate([_padded(prompt, S), want[:k]]),
                int(want[k]), int(got[k]))
    log(f"{label}: diverges at token {k} (uninterrupted {want[k]}, got "
        f"{got[k]}), logit margin {m:.3e}")
    if not m < TIE_MARGIN:
        fail(f"{label}: tokens differ beyond a tie (margin {m:.3e})")
    return m


def _drain_prompts(cfg, n_req=16, seed=0):
    """phase_e2e's requests: the same draws from the same seed (after its
    9-token warm-up prompt)."""
    rng = np.random.default_rng(seed)
    rng.integers(1, cfg.vocab_size, 9)
    lens = rng.permutation(np.linspace(4, 500, n_req).round().astype(int))
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _preempt_engine(torch, device, cfg, params, smi, ref, max_new=32):
    """The paged engine of the drains (8 slots, 640-token cache, 512-token
    budget) over the drains' 16 requests (``ref``: their uninterrupted
    streams, the paged drain's) with two preemptions: a decoding slot right after its first token and,
    after 60 iterations, of the slots 8 or fewer tokens from their end the
    one with the longest context. Each resumes by recomputing its
    context (the padded prompt plus its tokens) through paged prefill.
    Checks that each eviction returns the slot's blocks, that every stream
    equals the uninterrupted run (the resumed ones up to a near-tie), and
    the launches; then times one resume's re-prefill alone. Returns the
    launches."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    prompts = _drain_prompts(cfg)
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   device=device, params=params)
    eng.run(prompts[:1], max_new_tokens=2)  # warm-up
    it0, ch0 = eng.n_iters, eng.n_prefill_chunks
    reset_launches()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done, snaps, t0 = {}, [], time.perf_counter()
    while eng.waiting or eng.active_slots:
        for r in eng.step():
            done[r.request_id] = r
        dec = [i for i in eng.decoding_slots
               if eng.slots[i].n_preempted == 0]
        if len(snaps) == 0:
            pick = [i for i in dec if len(eng.slots[i].tokens) == 1]
        elif len(snaps) == 1 and eng.n_iters - it0 >= 60:
            # late: of the slots 8 or fewer tokens from their end, the
            # one with the longest context (the dearest to recompute)
            late = [i for i in dec if eng.slots[i].remaining <= 8]
            pick = sorted(late, key=lambda i: -len(
                eng.slots[i].seq_tokens))[:1]
        else:
            pick = []
        if pick:
            s = eng.slots[pick[0]]
            held = len(s.blocks) + s.n_outstanding
            avail = eng.allocator.n_available
            snaps.append(eng.preempt(pick[0]))
            if eng.allocator.n_available != avail + held:
                fail(f"preempt engine: blocks not returned "
                     f"({eng.allocator.n_available} != {avail} + {held})")
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    want = _want(cfg, "paged", n_iters=n_iters, n_chunks=n_chunks)
    if launches != want:
        fail(f"preempt engine: launches {launches} != {want}")
    if len(snaps) != 2 or eng.n_preempted != 2:
        fail(f"preempt engine: {len(snaps)} preemptions, expected 2")
    al = eng.allocator
    if al.n_free != al.n_blocks or al.n_reserved:
        fail(f"preempt engine: {al.n_blocks - al.n_free} blocks live, "
             f"{al.n_reserved} reserved after the drain")
    if sorted(done) != rids:
        fail(f"preempt engine: finished {sorted(done)}, submitted {rids}")
    victims = {s.request_id for s in snaps}
    for rid, p, want_tokens in zip(rids, prompts, ref):
        r = done[rid]
        if (r.n_preempted == 1) != (rid in victims):
            fail(f"preempt engine: request {rid} n_preempted "
                 f"{r.n_preempted}")
        if rid in victims:
            _hold_tie(torch, cfg, params, f"preempt engine request {rid}",
                      p, want_tokens, r.tokens)
        elif not np.array_equal(r.tokens, want_tokens):
            fail(f"preempt engine: request {rid}, never preempted, differs "
                 "from the uninterrupted run")
    log(f"preempt engine {cfg.name}: 16 requests on 8 slots, preempted "
        f"{[(s.request_id, s.base_len, len(s.seq_tokens)) for s in snaps]} "
        f"((request, padded prompt, resumed context)) after 1 and "
        f"{len(snaps[1].seq_tokens) - snaps[1].base_len} tokens; every "
        f"block returned at each eviction; {n_iters} decode iterations, "
        f"{n_chunks} prefill chunks, drain wall {wall:.3f} s; every stream "
        f"equals the uninterrupted run [{smi}]")
    log(f"preempt engine: launches {launches} == {want}")
    # one recompute resume alone: the late victim's context re-prefilled
    # on the idle engine under the 512-token budget
    snap = snaps[1]
    eng.submit_resume(snap)
    tok0, ch0 = eng.n_prefill_chunk_tokens, eng.n_prefill_chunks
    steps = [0]

    def reprefill():
        while eng.prefilling_slots or eng.waiting:
            eng.step()
            steps[0] += 1
    wall, busy, nk, names = _profiled(torch, reprefill)
    pre = _kernel_ms(names, PREFILL_KERNELS)
    log(f"preempt resume cost: a {len(snap.seq_tokens)}-token context "
        f"({snap.base_len} padded prompt + "
        f"{len(snap.seq_tokens) - snap.base_len} emitted) re-prefilled in "
        f"{eng.n_prefill_chunks - ch0} chunks "
        f"({eng.n_prefill_chunk_tokens - tok0} tokens) over {steps[0]} "
        f"steps: paged prefill kernel {pre:.3f} ms device, device busy "
        f"{busy:.3f} ms, profiled wall {wall * 1e3:.3f} ms [{smi}]")
    if not pre > 0:
        fail("preempt resume cost: no paged prefill kernel in the profile")
    while eng.active_slots:
        eng.step()
    return launches


def _pool_tokens(pool, rids):
    by_id = {r.request_id: r for m in pool.configs for r in pool.results(m)}
    return [by_id[i] for i in rids]


def _preempt_pool(torch, device, cfg, params, smi, seed=11,
                  label="preempt pool", **pool_kw):
    """The instance pool with ``preemption=True``: one paged instance of 4
    slots, its contention fit calibrated by a drain, then four lax-tier
    hogs fill the slots and two tight-tier requests arrive, the tight
    SLO 1.5 times the fit's predicted service time and the lax 4 times
    the tight. Checks at least one preemption, every request finished in
    full (none rejected or cancelled), the resumed tokens against one
    uninterrupted engine run of the same prompts, and the launches.
    ``pool_kw`` adds pool arguments (a host tier and its preemption
    mode). Returns (the launches, the pool)."""
    from repro_torch.serving import latency_model as lm
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.runtime import ModelInstancePool

    pool = ModelInstancePool({cfg.name: cfg}, max_instances=1, max_slots=4,
                             max_seq=640, kv_layout="paged", preemption=True,
                             device=device, **pool_kw)
    pool.load_params(cfg.name, params)
    pool.scale_to(cfg.name, 1)
    pool.warmup(seed=seed)
    rng = np.random.default_rng(seed)
    for n in (12, 40, 90):
        pool.submit(cfg.name, rng.integers(1, cfg.vocab_size, n).astype(
            np.int32), slo_ms=600_000.0, max_new_tokens=16)
    pool.run_until_drained()
    t1, c = pool.contention()
    if not t1 > 0:
        fail(f"{label}: contention uncalibrated after the drain "
             f"({len(pool.contention_samples)} samples)")
    it_ms = lm.predicted_iter_ms(t1, c, 1)
    tight_new, hog_new = 16, 64
    tight = 1.5 * tight_new * it_ms
    lax = 4.0 * tight
    eng = pool.running(cfg.name)[0].engine
    it0, ch0 = eng.n_iters, eng.n_prefill_chunks
    reset_launches()
    n0 = pool.n_preempted
    hogs = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in (30, 120, 250, 400)]
    urgent = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
              for n in (20, 60)]
    rids = [pool.submit(cfg.name, p, slo_ms=lax, max_new_tokens=hog_new)
            for p in hogs]
    t0 = time.perf_counter()
    while len(eng.decoding_slots) < 4:
        pool.step()
    rids += [pool.submit(cfg.name, p, slo_ms=tight,
                         max_new_tokens=tight_new) for p in urgent]
    pool.run_until_drained()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    want = _want(cfg, "paged", n_iters=n_iters, n_chunks=n_chunks, n_slots=4,
                 nb=40)
    if launches != want:
        fail(f"{label}: launches {launches} != {want}")
    n_pre = pool.n_preempted - n0
    if n_pre < 1:
        fail(f"{label}: no preemption (fit {t1:.3f} ms + {c:.3f}, "
             f"SLOs {tight:.1f} / {lax:.1f} ms)")
    res = _pool_tokens(pool, rids)
    if any(r.rejected or r.cancelled for r in res) or [
            len(r.tokens) for r in res] != [hog_new] * 4 + [tight_new] * 2:
        fail(f"{label}: requests not conserved: " + str(
            [(r.request_id, len(r.tokens), r.rejected, r.cancelled)
             for r in res]))
    solo = ContinuousBatchingEngine(cfg, max_slots=4, max_seq=640,
                                    kv_layout="paged", device=device,
                                    share_from=eng)
    alone = [r.tokens for r in solo.run(hogs, max_new_tokens=hog_new)] + \
        [r.tokens for r in solo.run(urgent, max_new_tokens=tight_new)]
    resumed = [rid for rid in rids if pool.admission_log.count(
        (rid, pool.running(cfg.name)[0].instance_id)) > 1]
    for rid, p, r, a in zip(rids, hogs + urgent, res, alone):
        _hold_tie(torch, cfg, params, f"{label} request {rid}", p, a,
                  r.tokens)
    tiers = {"tight": [r.latency_ms for r in res[4:]],
             "lax": [r.latency_ms for r in res[:4]]}
    log(f"{label} {cfg.name}: fit t1 {t1:.3f} ms c {c:.3f} (predicted "
        f"iteration {it_ms:.3f} ms), SLOs tight {tight:.1f} ms, lax "
        f"{lax:.1f} ms; {n_pre} preemption(s), resumed {resumed}; latency "
        f"ms tight {[round(x, 1) for x in tiers['tight']]}, lax "
        f"{[round(x, 1) for x in tiers['lax']]}; all 6 requests finished "
        f"in full, tokens equal the uninterrupted run; {n_iters} decode "
        f"iterations, {n_chunks} prefill chunks in {wall:.3f} s [{smi}]")
    log(f"{label}: report {pool.report()[cfg.name]}")
    log(f"{label}: launches {launches} == {want}")
    return launches, pool


def phase_preempt(torch, device, cfg, params, smi, ref_tokens):
    """Recompute preemption at full width: the engine (its streams held
    to ``ref_tokens``, the paged drain's) and the pool. Returns the
    summed launches."""
    launches = _preempt_engine(torch, device, cfg, params, smi, ref_tokens)
    for k, n in _preempt_pool(torch, device, cfg, params, smi)[0].items():
        launches[k] += n
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- spec
#: the depth the speculative engines are built for, and the live depth
#: through a drain: each entry for SPEC_TOGGLE_STEPS steps, the last to
#: the end
SPEC_K = 4
SPEC_TOGGLE = (4, 2, 0, 4)
SPEC_TOGGLE_STEPS = 12


def _spec_drain(torch, device, cfg, params, smi, kv_layout, prompts,
                ref_tokens, max_new=32):
    """The drains' engine (8 slots, 640-token cache, 512-token budget)
    built for ``SPEC_K`` over the drains' requests, its live depth
    toggled through ``SPEC_TOGGLE``: every stream against the k = 0
    drain's (``ref_tokens``, any gap held to a tie), launches exact (a
    verify forward is one paged chunk launch per layer, paged; plain
    PyTorch, dense). Then the verify forward and a decode iteration of
    eight resident sequences, one step each under the profiler.
    Returns (launches, numbers)."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    label = f"spec {kv_layout}"
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout=kv_layout, token_budget=512,
                                   spec_k=SPEC_K, device=device,
                                   params=params)
    eng.run([np.arange(1, 10, dtype=np.int32)], max_new_tokens=6)
    bad = []
    _watch_logits(torch, eng.model, bad,
                  ("decode_step", "prefill_chunk", "verify_step"))
    it0, ch0, sp0 = eng.n_iters, eng.n_prefill_chunks, eng.n_spec_steps
    pr0, ac0 = eng.n_spec_proposed, eng.n_spec_accepted
    reset_launches()
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    results, steps, spec_ms, dec_ms = [], 0, [], []
    t0 = time.perf_counter()
    while eng.waiting or eng.active_slots:
        eng.spec_k = SPEC_TOGGLE[min(steps // SPEC_TOGGLE_STEPS,
                                     len(SPEC_TOGGLE) - 1)]
        before, sp = eng.n_prefill_chunk_tokens, eng.n_spec_steps
        ts = time.perf_counter()
        results += eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - ts) * 1e3
        steps += 1
        if eng.n_prefill_chunk_tokens == before:
            (spec_ms if eng.n_spec_steps > sp else dec_ms).append(dt)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    n_spec = eng.n_spec_steps - sp0
    want = _want(cfg, kv_layout, n_iters=n_iters, n_chunks=n_chunks,
                 n_spec=n_spec)
    if launches != want:
        fail(f"{label}: launches {launches} != {want} ({n_iters} "
             f"iterations, {n_spec} speculative, {n_chunks} chunks)")
    if bool(torch.stack(bad).any()):
        fail(f"{label}: non-finite logits")
    results.sort(key=lambda r: r.request_id)
    if len(results) != len(prompts) or any(len(r.tokens) != max_new
                                           for r in results):
        fail(f"{label}: {len(results)} of {len(prompts)} finished in full")
    ties = [m for r, p, want_tokens in zip(results, prompts, ref_tokens)
            if (m := _hold_tie(torch, cfg, params, f"{label} request "
                               f"{r.request_id}", p, want_tokens,
                               r.tokens)) is not None]
    proposed = eng.n_spec_proposed - pr0
    accepted = eng.n_spec_accepted - ac0
    gen = sum(len(r.tokens) for r in results)
    num = {"accept_rate": accepted / max(proposed, 1), "n_spec": n_spec,
           "n_iters": n_iters, "tokens_per_iter": gen / n_iters,
           "spec_p50": float(np.percentile(spec_ms, 50)) if spec_ms else 0,
           "dec_p50": float(np.percentile(dec_ms, 50)) if dec_ms else 0,
           "wall": wall}
    log(f"{label} {cfg.name}: 16 drain requests, {max_new} new tokens, 8 "
        f"slots, depth {SPEC_TOGGLE} for {SPEC_TOGGLE_STEPS} steps each; "
        f"{n_iters} iterations ({n_spec} speculative), {n_chunks} prefill "
        f"chunks; drafts accepted {accepted} of {proposed} "
        f"({num['accept_rate']:.3f}); {num['tokens_per_iter']:.3f} tokens "
        f"per iteration ({gen} over {n_iters}); decode-only step wall ms "
        f"p50: verify "
        f"{num['spec_p50']:.3f} (n={len(spec_ms)}), plain decode "
        f"{num['dec_p50']:.3f} (n={len(dec_ms)}); drain wall {wall:.3f} s; "
        f"every stream equals the k = 0 drain's"
        f"{f' up to {len(ties)} tie(s)' if ties else ''} [{smi}]")
    log(f"{label}: launches {launches} == {want}")
    # the verify forward and a decode iteration of 8 resident sequences
    rng = np.random.default_rng(5)
    eng.spec_k = 0
    for n in (100, 200, 300, 400, 30, 60, 90, 120):
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=48)
    while eng.waiting or eng.prefill_backlog_tokens:
        eng.step()

    report = {}
    for k in (SPEC_K, 0):
        eng.spec_k = k
        sp = eng.n_spec_steps
        _, busy, nk, names = _profiled(torch, eng.step)
        if (eng.n_spec_steps - sp == 1) != (k > 0) or \
                len(eng.decoding_slots) != 8:
            fail(f"{label}: the profiled step at k={k} ran "
                 f"{eng.n_spec_steps - sp} verify forwards with "
                 f"{len(eng.decoding_slots)} slots")
        report[k] = (busy, nk, _kernel_ms(names, PREFILL_KERNELS),
                     _kernel_ms(names, DECODE_KERNELS if kv_layout == "paged"
                                else DENSE_DECODE_KERNELS))
    num.update(verify_busy=report[SPEC_K][0], verify_attn=report[SPEC_K][2],
               decode_busy=report[0][0], decode_attn=report[0][3])
    attn = (f"paged prefill kernel {report[SPEC_K][2]:.3f} ms"
            if kv_layout == "paged" else "its attention plain PyTorch")
    log(f"{label}: 8 resident sequences, per step: verify forward (W = "
        f"{1 + SPEC_K}) device busy {report[SPEC_K][0]:.3f} ms over "
        f"{report[SPEC_K][1]} kernels, {attn}; decode iteration device busy "
        f"{report[0][0]:.3f} ms over {report[0][1]} kernels, "
        f"{'paged' if kv_layout == 'paged' else 'dense'} decode kernels "
        f"{report[0][3]:.3f} ms [{smi}]")
    while eng.active_slots:
        eng.step()
    del eng
    torch.cuda.empty_cache()
    return launches, num


def _draft_drain(torch, device, cfg, params, smi, prompts, ref_tokens,
                 max_new=16):
    """The paged drains' engine with a ``DraftModelProposer`` whose draft
    is the target itself (the same params), over ``prompts``: streams
    against the k = 0 drain's first ``max_new`` tokens (held to a tie),
    launches exact (the draft's round mode adds one flash launch per
    layer and proposal and one dense decode launch per layer and drafted
    token), and the acceptance rate. Returns the launches."""
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            DraftModelProposer)

    draft = DraftModelProposer(cfg, device=device, params=params)
    calls = [0, 0]
    propose = draft.propose

    def counted(context, k):
        calls[0] += 1
        calls[1] += k
        return propose(context, k)
    draft.propose = counted
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   spec_k=SPEC_K, proposer=draft,
                                   device=device, params=params)
    reset_launches()
    t0 = time.perf_counter()
    res = eng.run(prompts, max_new_tokens=max_new)
    wall = time.perf_counter() - t0
    launches = read_launches()
    A = cfg.n_layers
    want = _want(cfg, "paged", n_iters=eng.n_iters,
                 n_chunks=eng.n_prefill_chunks, n_spec=eng.n_spec_steps)
    want["flash_attention"] += A * calls[0]
    want["decode_attention"] += A * calls[1]
    if launches != want:
        fail(f"spec draft: launches {launches} != {want}")
    for r, p, w in zip(res, prompts, ref_tokens):
        _hold_tie(torch, cfg, params, f"spec draft request {r.request_id}",
                  p, w[:max_new], r.tokens)
    log(f"spec draft {cfg.name}: DraftModelProposer with the target's own "
        f"weights, {len(prompts)} requests, {max_new} new tokens, k = "
        f"{SPEC_K}; {eng.n_spec_steps} verify forwards, {calls[0]} "
        f"proposals of {calls[1]} drafts, accepted {eng.n_spec_accepted} of "
        f"{eng.n_spec_proposed} (rate {eng.spec_accept_rate:.3f}); "
        f"{sum(len(r.tokens) for r in res)} tokens in {eng.n_iters} "
        f"iterations, wall {wall:.3f} s; streams equal the k = 0 drain's "
        f"[{smi}]")
    log(f"spec draft: launches {launches} == {want}")
    del eng, draft
    torch.cuda.empty_cache()
    return launches


def phase_spec(torch, device, cfg, params, smi, ref_tokens):
    """Speculative decoding at full width: the drains' engine paged and
    dense built for k = 4 with its depth toggled mid-drain, streams held
    to the k = 0 drains' (``ref_tokens``: layout -> tokens per request),
    then a draft-model run. Returns the summed launches."""
    prompts = _drain_prompts(cfg)
    launches = {name: 0 for name in REPLACES}
    nums = {}
    for layout in ("paged", "dense"):
        got, nums[layout] = _spec_drain(torch, device, cfg, params, smi,
                                        layout, prompts, ref_tokens[layout])
        for k, n in got.items():
            launches[k] += n
    for k, n in _draft_drain(torch, device, cfg, params, smi, prompts[:2],
                             ref_tokens["paged"][:2]).items():
        launches[k] += n
    return launches, nums


# ---------------------------------------------------------------- swap
#: host blocks of the swap drain's engine: two victims of up to 34
#: blocks each (a 539-token context) with room to spare
SWAP_HOST_BLOCKS = 80


def _block_bytes(torch, eng, bids):
    """Every paged pool's rows of blocks ``bids`` (copies)."""
    idx = torch.tensor(bids, device=eng.cache[0]["k"].device)
    return [{k: c[k].index_select(0, idx) for k in ("k", "v")}
            for c in eng.cache]


def _pinned_mib(eng):
    """The engine's pinned host memory: its host pool (one dead block
    included) and its staging area, in MiB."""
    pool = sum(t.numel() * t.element_size() for h in eng.host_pool
               for t in h.values())
    stage = sum(t.numel() * t.element_size() for h in eng._staging or ()
                for t in h.values())
    return f"{pool / 2**20:.1f} + {stage / 2**20:.1f} (pool + staging)"


def _swap_drain(torch, device, cfg, params, smi, ref_tokens, max_new=32):
    """The drains' paged engine with a host tier over the drains'
    requests: once nothing waits, the two decoding slots with the longest
    contexts are swapped out (requeue off), and resumed two steps later,
    each admission timed to the end of its copy. Every stream equals the
    k = 0 drain's (the swapped ones up to a tie), every block comes back,
    launches exact. Then a recompute resume of the longer victim's same
    context on the same engine, timed and profiled. Returns (engine,
    launches, numbers)."""
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            to_recompute)

    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   kv_host_blocks=SWAP_HOST_BLOCKS,
                                   device=device, params=params)
    bpb = eng.swap_bytes_per_block
    log(f"swap {cfg.name}: host tier of {SWAP_HOST_BLOCKS} blocks of {bpb} "
        f"bytes (every layer's K and V): {_pinned_mib(eng)} MiB pinned")
    prompts = _drain_prompts(cfg)
    eng.run(prompts[:1], max_new_tokens=2)  # warm-up
    it0, ch0 = eng.n_iters, eng.n_prefill_chunks
    reset_launches()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done, snaps, outs, ins, resumed = {}, [], [], [], {}
    steps, resume_at = 0, None
    t0 = time.perf_counter()
    while eng.waiting or eng.active_slots or (snaps and not resumed):
        for r in eng.step():
            done[r.request_id] = r
        steps += 1
        if not snaps and not eng.waiting:
            dec = [i for i in eng.decoding_slots
                   if len(eng.slots[i].tokens) >= 2
                   and eng.slots[i].remaining >= 8]
            if len(dec) >= 2:
                for i in sorted(dec, key=lambda i: -int(eng.pos[i]))[:2]:
                    s = eng.slots[i]
                    held = len(s.blocks) + s.n_outstanding
                    avail = eng.allocator.n_available
                    snap = eng.preempt(i, requeue=False, mode="swap")
                    if eng.allocator.n_available != avail + held:
                        fail(f"swap: blocks not returned at preemption "
                             f"({eng.allocator.n_available} != {avail} + "
                             f"{held})")
                    outs.append(eng.swap_samples[-1])
                    snaps.append(snap)
                resume_at = steps + 2
        if snaps and not resumed and steps >= resume_at:
            for snap in snaps:
                rid = eng.submit_resume(snap)
                torch.cuda.synchronize()
                ts = time.perf_counter()
                eng.admit()
                torch.cuda.synchronize()
                ins.append((eng.swap_samples[-1][0],
                            (time.perf_counter() - ts) * 1e3,
                            eng.swap_samples[-1][1]))
                resumed[rid] = snap.request_id
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    want = _want(cfg, "paged", n_iters=n_iters, n_chunks=n_chunks)
    if launches != want:
        fail(f"swap: launches {launches} != {want}")
    if len(snaps) != 2 or eng.n_swap_preempts != 2 \
            or eng.n_swap_resumes != 2:
        fail(f"swap: {len(snaps)} snapshots, {eng.n_swap_preempts} swap "
             f"preempts, {eng.n_swap_resumes} swap resumes; expected 2")
    al = eng.allocator
    if al.n_live or al.n_reserved or al.n_host_live or \
            al.n_host_free != al.n_host_blocks:
        fail(f"swap: after the drain {al.n_live} blocks live, "
             f"{al.n_reserved} reserved, {al.n_host_live} host blocks held")
    by_orig = {resumed.get(rid, rid): r for rid, r in done.items()}
    if sorted(by_orig) != rids:
        fail(f"swap: finished {sorted(by_orig)}, submitted {rids}")
    victims = {s.request_id for s in snaps}
    for rid, p, w in zip(rids, prompts, ref_tokens):
        r = by_orig[rid]
        if rid in victims:
            _hold_tie(torch, cfg, params, f"swap request {rid}", p, w,
                      r.tokens)
        elif not np.array_equal(r.tokens, w):
            fail(f"swap: request {rid}, never preempted, differs from "
                 "the uninterrupted run")
    num = {"out": outs, "in": ins, "contexts": [s.pos for s in snaps],
           "blocks": [len(s.host_blocks) for s in snaps]}
    log(f"swap {cfg.name}: 16 requests on 8 slots, swapped out "
        f"{[(s.request_id, s.pos, len(s.host_blocks)) for s in snaps]} "
        f"((request, context tokens, blocks)) and resumed 2 steps later; "
        f"{n_iters} decode iterations, {n_chunks} prefill chunks, drain "
        f"wall {wall:.3f} s; every stream equals the uninterrupted drain; "
        f"both tiers conserved [{smi}]")
    for (b, ms), (bi, ms_in, disp), s in zip(outs, ins, snaps):
        log(f"swap {cfg.name}: a {s.pos}-token context, {b / 1e6:.3f} MB: "
            f"swap-out {ms:.3f} ms (gather, copy to pinned host, "
            f"synchronize; {b / 1e6 / ms:.2f} GB/s), swap-in "
            f"{ms_in:.3f} ms (admission to the end of the copy; "
            f"{bi / 1e6 / ms_in:.2f} GB/s; dispatch {disp:.3f} ms) [{smi}]")
    log(f"swap: launches {launches} == {want}")
    # the longer victim's same context, recomputed on the same engine:
    # once timed to its first decode step, once under the profiler
    snap = max(snaps, key=lambda x: x.pos)
    vi = rids.index(snap.request_id)
    for profile in (False, True):
        rec = to_recompute(snap)
        rid = eng.submit_resume(rec)
        ch1, tok1, steps = eng.n_prefill_chunks, eng.n_prefill_chunk_tokens, [0]

        def reprefill():
            while eng.prefilling_slots or eng.waiting:
                eng.step()
                steps[0] += 1
        torch.cuda.synchronize()
        if profile:
            rw, busy, _, names = _profiled(torch, reprefill)
            num.update(rec_busy=busy,
                       rec_prefill=_kernel_ms(names, PREFILL_KERNELS))
        else:
            ts = time.perf_counter()
            reprefill()
            torch.cuda.synchronize()
            rw = time.perf_counter() - ts
            num.update(rec_wall=rw * 1e3)
        out = []
        while eng.active_slots:
            out += eng.step()
        [r] = [x for x in out if x.request_id == rid]
        _hold_tie(torch, cfg, params, f"swap recompute resume ({profile=})",
                  prompts[vi], ref_tokens[vi], r.tokens)
        log(f"swap recompute resume: the same {len(rec.seq_tokens)}-token "
            f"context re-prefilled in {eng.n_prefill_chunks - ch1} chunks "
            f"({eng.n_prefill_chunk_tokens - tok1} tokens) over {steps[0]} "
            f"steps: "
            + (f"device busy {num['rec_busy']:.3f} ms, paged prefill "
               f"{num['rec_prefill']:.3f} ms, profiled wall {rw * 1e3:.3f}"
               f" ms" if profile else f"wall {rw * 1e3:.3f} ms to its "
               "first decode step (unprofiled)")
            + f"; tokens equal the uninterrupted run [{smi}]")
    return eng, launches, num


def _spill_revive(torch, device, cfg, params, smi, ref_eng, max_new=8):
    """Prefix spill and revival under a tight device budget: one slot,
    70 blocks (two 508-token prompts' worth), 40 host blocks, the prefix
    cache on. A prompt's cached blocks are reclaimed by two fillers and
    spill to the host tier; a prompt of the same 500-token prefix then
    revives them, and every revived block's bytes equal the original's.
    Its tokens are held to ``ref_eng``'s run of it (no cache). Returns
    the launches."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, max_slots=1, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   kv_blocks=70, kv_host_blocks=40,
                                   prefix_cache=True, device=device,
                                   params=params)
    rng = np.random.default_rng(31)
    pa = _prefix_prompts(cfg, 1, seed=5)[0]
    pb = pa.copy()
    pb[-8:] = rng.integers(1, cfg.vocab_size, 8)
    fillers = [rng.integers(1, cfg.vocab_size, 508).astype(np.int32)
               for _ in range(2)]
    reset_launches()
    eng.run([pa], max_new_tokens=max_new)
    al = eng.allocator
    keys = eng._chain_keys(eng._padded_seq(pa))[:31]  # prefix-only blocks
    orig = _block_bytes(torch, eng, [al._cache[k] for k in keys])
    for f in fillers:
        eng.run([f], max_new_tokens=max_new)
    spilled = [k for k in keys if k in al._host_cache]
    if not spilled or al.n_spilled < len(spilled):
        fail(f"spill: {al.n_spilled} spills, {len(spilled)} of the "
             "prompt's blocks on the host")
    hits = eng.n_prefix_hit_tokens
    tb = eng.run([pb], max_new_tokens=max_new)[0].tokens
    launches = read_launches()
    want = _want(cfg, "paged", n_iters=eng.n_iters,
                 n_chunks=eng.n_prefill_chunks)
    if launches != want:
        fail(f"spill: launches {launches} != {want}")
    if al.n_unspilled < len(spilled) or \
            eng.n_prefix_hit_tokens - hits != 31 * eng.block_size:
        fail(f"spill: {al.n_unspilled} revivals of {len(spilled)} spilled "
             f"blocks, {eng.n_prefix_hit_tokens - hits} hit tokens")
    now = _block_bytes(torch, eng, [al._cache[k] for k in keys])
    changed = sum(int(not torch.equal(a[k], b[k]))
                  for a, b in zip(now, orig) for k in ("k", "v"))
    if changed:
        fail(f"spill: {changed} of {2 * cfg.n_layers} pools' revived "
             "blocks differ from the originals")
    if al.n_host_free + al.n_host_cached + al.n_host_live \
            != al.n_host_blocks:
        fail("spill: host tier not conserved")
    want_b = ref_eng.run([pb], max_new_tokens=max_new)[0].tokens
    m = _hold_tie(torch, cfg, params, "spill revived prompt", pb, want_b, tb)
    log(f"spill {cfg.name}: 1 slot, 70 device and 40 host blocks "
        f"({_pinned_mib(eng)} MiB pinned); two "
        f"fillers spilled {len(spilled)} of a 508-token prompt's 31 prefix "
        f"blocks ({al.n_spilled} spills in all), a prompt of the same "
        f"prefix revived them ({al.n_unspilled} revivals, 496 hit tokens): "
        f"every revived block's bytes equal the original's in all "
        f"{2 * cfg.n_layers} pools; its tokens equal a run without the "
        f"cache{' up to a tie' if m is not None else ''}; transfer samples "
        f"(bytes, ms) {[(b, round(t, 3)) for b, t in eng.swap_samples[:3]]}"
        f"... [{smi}]")
    log(f"spill: launches {launches} == {want}")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_swap(torch, device, cfg, params, smi, ref_tokens):
    """The host KV tier at full width, paged: swap preemption and resume
    in the drains (beside a recompute resume of the same context), prefix
    spill and revival under a tight budget, and the 4-slot pool with
    ``preempt_mode="auto"`` under two SLO tiers 4x apart, its picks and
    its swap-cost fit logged. Returns the summed launches."""
    from repro_torch.serving import latency_model as lm

    eng, launches, _ = _swap_drain(torch, device, cfg, params, smi,
                                   ref_tokens)
    for k, n in _spill_revive(torch, device, cfg, params, smi,
                              eng).items():
        launches[k] += n
    del eng
    torch.cuda.empty_cache()
    got, pool = _preempt_pool(torch, device, cfg, params, smi, seed=13,
                              label="swap pool", kv_host_blocks=64,
                              preempt_mode="auto")
    for k, n in got.items():
        launches[k] += n
    samples = [x for i in pool.live() for x in i.engine.swap_samples]
    st = pool.stats()
    log(f"swap pool: preempt_mode auto, 64 host blocks per instance "
        f"({_pinned_mib(pool.live()[0].engine)} MiB pinned); "
        f"{pool.n_preempted} preemption(s), {pool.n_swap_preempted} by swap "
        f"and {pool.n_preempted - pool.n_swap_preempted} by recompute; "
        f"swap-cost fit (base_ms, ms_per_mb) {pool.swap_cost()} (the "
        f"pool's, after 4 samples), {lm.fit_swap_cost(samples)} over the "
        f"{len(samples)} samples {[(b, round(t, 3)) for b, t in samples]}; "
        f"token-cost fit {pool.token_cost()}; kv_host_frac "
        f"{st['kv_host_frac']:.3f} [{smi}]")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- prefix
#: the prefix-cache phase's templated prompts: one of two 500-token
#: shared prefixes plus the fixed 8-token tail (508 tokens: a 512 bucket
#: of 32 blocks of 16, the first 31 holding padding and prefix only, so a
#: hit maps 31 blocks and prefills one 16-token chunk at position 496)
PREFIX_TOKENS = 500


def _prefix_prompts(cfg, n, seed, population=2):
    from repro_torch.launch.engine_serve import _shared_prefix_prompts

    draw = _shared_prefix_prompts(np.random.default_rng(seed),
                                  cfg.vocab_size, PREFIX_TOKENS, population)
    return [draw() for _ in range(n)]


def _cached_blocks(eng, prompt):
    """The pool block ids the prefix cache holds for ``prompt``'s full
    padded blocks, in chain order (stops at the first miss)."""
    al = eng.allocator
    out = []
    for key in eng._chain_keys(eng._padded_seq(prompt)):
        if key not in al._cache:
            break
        out.append(al._cache[key])
    return out


def _prefix_drain(torch, device, cfg, params, smi, prompts, prefix_cache,
                  max_new):
    """The drains' paged engine (8 slots, 640-token cache, 512-token
    budget) over ``prompts`` with the prefix cache on or off: tokens,
    launches (checked exactly), TTFT and the host time of the steps that
    prefilled. Then one more prompt of the first family alone, its
    prefill step profiled. Returns (engine, results, launches, numbers)."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    label = f"prefix {'on' if prefix_cache else 'off'}"
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   prefix_cache=prefix_cache, device=device,
                                   params=params)
    eng.run([np.arange(1, 10, dtype=np.int32)], max_new_tokens=2)  # warm-up
    it0, ch0, tok0 = eng.n_iters, eng.n_prefill_chunks, \
        eng.n_prefill_chunk_tokens
    bad = []
    _watch_logits(torch, eng.model, bad, ("decode_step", "prefill_chunk"))
    reset_launches()
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    # TTFT in engine steps as well as on the host clock: the step count
    # does not drift with the host
    first_step, n_steps = {}, [0]
    eng.on_token = lambda rid, tok, idx: first_step.setdefault(
        rid, n_steps[0] + 1)
    results, pre_s, t0 = [], 0.0, time.perf_counter()
    while eng.waiting or eng.active_slots:
        before = eng.n_prefill_chunk_tokens
        ts = time.perf_counter()
        results += eng.step()
        torch.cuda.synchronize()
        n_steps[0] += 1
        if eng.n_prefill_chunk_tokens != before:
            pre_s += time.perf_counter() - ts
    eng.on_token = None
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    want = _want(cfg, "paged", n_iters=n_iters, n_chunks=n_chunks)
    if launches != want:
        fail(f"{label}: launches {launches} != {want} ({n_iters} decode "
             f"iterations, {n_chunks} prefill chunks)")
    if bool(torch.stack(bad).any()):
        fail(f"{label}: non-finite logits")
    results.sort(key=lambda r: r.request_id)
    if len(results) != len(prompts) or any(len(r.tokens) != max_new
                                           for r in results):
        fail(f"{label}: {len(results)} of {len(prompts)} finished")
    ttft = [r.ttft_s * 1e3 for r in results]
    steps = [first_step[r.request_id] for r in results]
    num = {"ttft_p50": float(np.percentile(ttft, 50)),
           "ttft_p90": float(np.percentile(ttft, 90)),
           "steps_p50": float(np.percentile(steps, 50)),
           "steps_p90": float(np.percentile(steps, 90)),
           "chunks": n_chunks, "chunk_tokens":
           eng.n_prefill_chunk_tokens - tok0, "prefill_s": pre_s,
           "wall": wall, "hits": eng.n_prefix_hits,
           "hit_tokens": eng.n_prefix_hit_tokens}
    log(f"{label} {cfg.name}: {len(prompts)} requests of a 500-token shared "
        f"prefix (2 prefixes) + 8-token tail, {max_new} new tokens, 8 slots; "
        f"{n_iters} decode iterations, {n_chunks} prefill chunks "
        f"({num['chunk_tokens']} tokens), prefix hits {num['hits']} "
        f"({num['hit_tokens']} tokens); TTFT ms p50 {num['ttft_p50']:.3f} "
        f"p90 {num['ttft_p90']:.3f}, per request "
        f"{[round(x) for x in ttft]}; in engine steps p50 "
        f"{num['steps_p50']:.1f} p90 {num['steps_p90']:.1f}, per request "
        f"{steps}; steps with prefill {pre_s:.3f} s of the drain's "
        f"{wall:.3f} s over {n_steps[0]} steps (host) [{smi}]")
    log(f"{label}: launches {launches} == {want} (paged prefill: "
        f"{launches['paged_prefill_attention']} = {cfg.n_layers} layers x "
        f"{n_chunks} chunks)")
    # one request alone: the step that prefills it, under the profiler
    extra = _prefix_prompts(cfg, 1, seed=99)[0]
    extra[:PREFIX_TOKENS] = prompts[0][:PREFIX_TOKENS]
    eng.submit(extra, max_new_tokens=2)
    ch1, tok1 = eng.n_prefill_chunks, eng.n_prefill_chunk_tokens
    wall1, busy, nk, names = _profiled(torch, eng.step)
    pre_ms = _kernel_ms(names, PREFILL_KERNELS)
    num.update(one_busy=busy, one_prefill_ms=pre_ms,
               one_tokens=eng.n_prefill_chunk_tokens - tok1)
    log(f"{label}: one request's prefill step ({num['one_tokens']} prompt "
        f"tokens in {eng.n_prefill_chunks - ch1} chunk(s)): device busy "
        f"{busy:.3f} ms, paged prefill kernel {pre_ms:.3f} ms, the rest "
        f"(projections, MLP, norms, the head, one decode) "
        f"{busy - pre_ms:.3f} ms; {nk} kernels, profiled wall "
        f"{wall1 * 1e3:.3f} ms [{smi}]")
    while eng.active_slots or eng.waiting:
        eng.step()
    return eng, results, launches, num


def _prefix_cow(torch, cfg, params, smi, eng, max_new=8):
    """One padded prompt served twice on the cache-on engine: the second
    admission's chain covers the whole prompt, so its tail block is
    copied (copy-on-write) and only the last token is re-scored. The
    second run's tokens equal the first's, and no block the cache holds
    for the prompt changed a byte. Returns the launches."""
    A = cfg.n_layers
    prompt = _prefix_prompts(cfg, 1, seed=77)[0]
    first = eng.run([prompt], max_new_tokens=max_new)[0].tokens
    bids = _cached_blocks(eng, prompt)
    if len(bids) != 32:
        fail(f"prefix cow: {len(bids)} of 32 prompt blocks cached")
    idx = torch.tensor(bids, device=eng.cache[0]["k"].device)
    before = [{k: c[k].index_select(0, idx) for k in ("k", "v")}
              for c in eng.cache]
    hits, hit_tok, ch0 = eng.n_prefix_hits, eng.n_prefix_hit_tokens, \
        eng.n_prefill_chunks
    reset_launches()
    it0 = eng.n_iters
    again = eng.run([prompt], max_new_tokens=max_new)[0].tokens
    launches = read_launches()
    n_chunks = eng.n_prefill_chunks - ch0
    want = _want(cfg, "paged", n_iters=eng.n_iters - it0, n_chunks=n_chunks)
    if launches != want:
        fail(f"prefix cow: launches {launches} != {want}")
    if eng.n_prefix_hits != hits + 1 or \
            eng.n_prefix_hit_tokens - hit_tok != 511 or n_chunks != 1:
        fail(f"prefix cow: hits {eng.n_prefix_hits - hits}, hit tokens "
             f"{eng.n_prefix_hit_tokens - hit_tok}, chunks {n_chunks}; "
             "expected a full-cover hit of 511 tokens and one T = 1 chunk")
    if not np.array_equal(first, again):
        fail(f"prefix cow: the repeat's tokens {again.tolist()} differ from "
             f"the first run's {first.tolist()}")
    changed = sum(int(not torch.equal(c[k].index_select(0, idx), b[k]))
                  for c, b in zip(eng.cache, before) for k in ("k", "v"))
    if changed:
        fail(f"prefix cow: {changed} of {2 * A} layer pools changed a "
             "shared block")
    log(f"prefix cow {cfg.name}: the same 508-token prompt twice; the "
        f"repeat mapped 31 shared blocks, copied the 32nd and re-scored 1 "
        f"token in {n_chunks} chunk (paged prefill launches "
        f"{launches['paged_prefill_attention']}); {max_new} tokens equal "
        f"the first run's; the 32 cached blocks' bytes unchanged in all "
        f"{2 * A} K/V pools [{smi}]")
    return launches


def phase_prefix(torch, device, cfg, params, smi, n_req=16, max_new=32,
                 seed=21):
    """The prefix cache at full width, paged, fp32: the drains' engine
    over 16 templated requests with the cache off and on (streams
    identical, exact paged prefill launches, hits, TTFT, one request's
    prefill step profiled each way), a fully covering repeat
    (copy-on-write; the shared blocks' bytes unchanged),
    ``serve_continuous`` with ``prefix_cache`` over a 500-token template,
    and the pool pair of qwen3-0.6b and recurrentgemma-2b under the paged
    layout with the prefix cache (``serve_pool``): qwen3 hits,
    recurrentgemma-2b serves paged without it through ``rglru_scan`` and
    dense decode. Returns the summed launches."""
    from repro_torch.config import get_config
    from repro_torch.launch.engine_serve import serve_continuous

    launches = {name: 0 for name in REPLACES}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    prompts = _prefix_prompts(cfg, n_req, seed)
    runs = {}
    for pc in (False, True):
        eng, res, got, num = _prefix_drain(torch, device, cfg, params, smi,
                                           prompts, pc, max_new)
        add(got)
        runs[pc] = (res, num)
        if pc:
            add(_prefix_cow(torch, cfg, params, smi, eng))
        del eng
        torch.cuda.empty_cache()
    exact = 0
    for p, a, b in zip(prompts, runs[False][0], runs[True][0]):
        if _hold_tie(torch, cfg, params, f"prefix request {a.request_id}",
                     p, a.tokens, b.tokens) is None:
            exact += 1
    off, on = runs[False][1], runs[True][1]
    if not on["hits"] > 0:
        fail("prefix on: no prefix hit in the drain")
    log(f"prefix {cfg.name}: {exact} of {n_req} streams token-identical with "
        f"the cache off and on (the rest at a near-tie); prefill chunk "
        f"tokens {off['chunk_tokens']} -> {on['chunk_tokens']}, chunks "
        f"{off['chunks']} -> {on['chunks']}; TTFT p50 "
        f"{off['ttft_p50']:.3f} -> {on['ttft_p50']:.3f} ms, p90 "
        f"{off['ttft_p90']:.3f} -> {on['ttft_p90']:.3f}; in steps p50 "
        f"{off['steps_p50']:.1f} -> {on['steps_p50']:.1f}, p90 "
        f"{off['steps_p90']:.1f} -> {on['steps_p90']:.1f}; one request's "
        f"prefill step device busy {off['one_busy']:.3f} -> "
        f"{on['one_busy']:.3f} ms (paged prefill {off['one_prefill_ms']:.3f}"
        f" -> {on['one_prefill_ms']:.3f}, the rest "
        f"{off['one_busy'] - off['one_prefill_ms']:.3f} -> "
        f"{on['one_busy'] - on['one_prefill_ms']:.3f}) [{smi}]")
    # serve_continuous over the template, cache on
    reset_launches()
    stats = serve_continuous(cfg=cfg, kv_layout="paged", duration_s=3.0,
                             max_slots=4, prefix_cache=True,
                             shared_prefix_tokens=PREFIX_TOKENS,
                             device=device)
    got = read_launches()
    # _serve_max_seq(500) = 576: 36 table columns of 16
    want = _want(cfg, "paged", n_iters=int(stats["n_iters"]),
                 n_chunks=int(stats["n_prefill_chunks"]), n_slots=4, nb=36)
    if stats["served"] < 1 or got != want or not \
            stats["prefix_hit_rate"] > 0:
        fail(f"serve_continuous prefix: served {stats['served']}, hit rate "
             f"{stats['prefix_hit_rate']}, launches {got} != {want}")
    add(got)
    log(f"serve_continuous {cfg.name} paged, prefix cache, 500-token "
        f"template (4 slots): {stats['served']:.0f} requests in 3 s, "
        f"prefix_hit_rate {stats['prefix_hit_rate']:.4f}, n_prefix_hits "
        f"{stats['n_prefix_hits']:.0f}, kv_shared_frac "
        f"{stats['kv_shared_frac']:.3f}; launches {got} == {want} [{smi}]")
    torch.cuda.empty_cache()
    # the verify skill's pool pair, paged, with the prefix cache
    got, probe, report = _pool_run(
        torch, device, smi, "paged pair, prefix cache",
        models=list(POOL_DENSE), cfgs={m: get_config(m) for m in POOL_DENSE},
        kv_layout="paged", prefix_cache=True,
        shared_prefix_tokens=PREFIX_TOKENS, duration_s=8.0, rps=2.0,
        slo_ms=5000.0, max_new_tokens=8)
    add(got)
    pool = probe.pool
    engines = [i.engine.stats() for lst in pool.instances.values()
               for i in lst] + [i.engine_stats for i in pool.retired]
    models = [i.model for lst in pool.instances.values() for i in lst] \
        + [i.model for i in pool.retired]
    hits = {m: sum(st["n_prefix_hits"] for st, mm in zip(engines, models)
                   if mm == m) for m in POOL_DENSE}
    cached = {i.model: i.engine.prefix_cache for i in pool.live()}
    occ = pool.kv_occupancy()
    if not (hits[FULL] > 0 and not hits[POOL_DENSE[1]]
            and not cached.get(POOL_DENSE[1], False)
            and got["rglru_scan"] > 0 and got["decode_attention"] > 0
            and occ["committed_blocks"] > 0):
        fail(f"pool pair prefix: hits {hits}, prefix cache per model "
             f"{cached}, launches {got}, committed blocks "
             f"{occ['committed_blocks']}")
    log(f"pool pair paged with the prefix cache: prefix hits {hits}, cache "
        f"per model {cached}, kv_committed_blocks "
        f"{occ['committed_blocks']:.0f}, prefix_hit_rate (live) "
        f"{occ['prefix_hit_rate']:.4f}; recurrentgemma-2b through "
        f"rglru_scan ({got['rglru_scan']}) and dense decode "
        f"({got['decode_attention']}) [{smi}]")
    del probe, pool
    torch.cuda.empty_cache()
    return launches


def _tiny_kinds():
    """The TINY-scale layer families of the repo's tests (windowed,
    RG-LRU hybrid, RWKV, all-windowed with an 8-slot ring), rebuilt here
    since the tests' configuration module imports jax."""
    from repro_torch.config.base import ModelConfig

    r = dataclasses.replace
    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=97)
    return {"windowed": r(tiny, name="tiny-win", sliding_window=16,
                          block_pattern=("attn", "local_attn")),
            "rglru": r(tiny, name="tiny-rg", family="hybrid",
                       block_pattern=("rglru", "attn")),
            "rwkv": r(tiny, name="tiny-rwkv", family="ssm", d_model=64,
                      block_pattern=("rwkv",), rwkv_head_size=32),
            "swa": r(tiny, name="tiny-swa", sliding_window=8,
                     block_pattern=("local_attn",))}


def phase_prefix_parity(torch, device, seed=0):
    """Card against CPU at reduced width under the paged layout: the
    TINY-scale hybrid, windowed and RWKV stacks (rings and states beside
    the pool), and reduced qwen3-0.6b's prefix-cache drains (two waves of
    same-prefix requests, then a fully covering repeat). Same weights
    (drawn on the CPU), same requests: greedy tokens identical (a
    divergence counts only at a logit margin below 1e-5), and the same
    hits on both."""
    from repro_torch.config import get_reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import (SEQ_BUCKETS,
                                            ContinuousBatchingEngine,
                                            _bucket)

    def serve(cfg, params, dev, waves, **kw):
        eng = ContinuousBatchingEngine(cfg, max_slots=3, max_seq=96,
                                       kv_layout="paged", block_size=8,
                                       token_budget=12, device=dev,
                                       params=params, **kw)
        out = [r.tokens for w in waves for r in eng.run(w, max_new_tokens=8)]
        return out, eng.n_prefix_hits, eng.n_prefix_hit_tokens

    for name, cfg in _tiny_kinds().items():
        params = init_params(cfg, seed=seed, device="cpu")
        rng = np.random.default_rng(seed + 5)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (3, 14, 9, 30, 6, 22)]
        reset_launches()
        card = serve(cfg, params, device, [prompts])[0]
        n = read_launches()
        cpu = serve(cfg, params, torch.device("cpu"), [prompts])[0]
        n_tok = _compare(torch, cfg, params, f"paged {name}", prompts,
                         [_bucket(len(p), buckets=SEQ_BUCKETS)
                          for p in prompts], card, cpu)
        log(f"parity paged {name} (kinds {sorted(set(cfg.layer_kinds()))}):"
            f" {len(prompts)} requests, {n_tok} greedy tokens identical on "
            f"card and CPU; card launches "
            f"{ {k: v for k, v in n.items() if v} }")
    cfg = get_reduced_config(FULL)
    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 6)
    head = rng.integers(1, cfg.vocab_size, 40).astype(np.int32)
    fam = [np.concatenate([head, rng.integers(1, cfg.vocab_size, 4).astype(
        np.int32)]) for _ in range(4)]
    waves = [fam[:2], fam[2:], fam[:1]]  # the last one covers fully
    card, hc, tc = serve(cfg, params, device, waves, prefix_cache=True)
    cpu, hp, tp = serve(cfg, params, torch.device("cpu"), waves,
                        prefix_cache=True)
    flat = [p for w in waves for p in w]
    n_tok = _compare(torch, cfg, params, "prefix cache", flat, [64] * 5,
                     card, cpu)
    if (hc, tc) != (hp, tp) or not hc:
        fail(f"parity prefix cache: hits card {(hc, tc)}, cpu {(hp, tp)}")
    log(f"parity prefix cache {cfg.name} reduced: 5 requests in 3 waves of "
        f"one 40-token prefix, {hc} hits ({tc} tokens) on both, {n_tok} "
        f"greedy tokens identical on card and CPU")


class _Hold:
    """Holds a pool's progress from the next token it emits on: while set,
    ``_can_progress`` reads false, so the serving driver idles (outside
    its lock) until ``release``. The engines call
    ``pool._on_engine_token`` through the instance, so wrapping it there
    sees every token."""

    def __init__(self, pool):
        import threading

        self.held = threading.Event()
        self.armed = False
        on_token, can_progress = pool._on_engine_token, pool._can_progress

        def _on_token(*a):
            on_token(*a)
            if self.armed:
                self.held.set()

        pool._on_engine_token = _on_token
        pool._can_progress = lambda: can_progress() and \
            not self.held.is_set()

    def arm(self):
        self.held.clear()
        self.armed = True

    def release(self):
        self.armed = False
        self.held.clear()


async def _raw_post(port, obj):
    import asyncio

    body = json.dumps(obj).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST /v1/generate HTTP/1.1\r\nContent-Length: "
                  f"{len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = await reader.readline()
    while await reader.readline() not in (b"\r\n", b"\n", b""):
        pass
    return reader, writer, status.decode()


async def _get_stats(port):
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /v1/stats HTTP/1.1\r\n\r\n")
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


HTTP_WAIT_S = 60.0


def phase_http(torch, device, cfg, params, smi, n_req=8, max_new=24,
               seed=12):
    """Push-mode serving at full width in this process: a ServingDriver
    thread steps a pool of one paged instance of 4 slots (640-token cache)
    and a ServingFrontend on port 0 streams over HTTP. Eight concurrent
    ``http_generate`` clients must each stream the tokens the same
    requests get through the offline pool; a client that hangs up after
    its first token is cancelled and its KV freed; with a queue depth of
    1 and the slots pinned a burst gets 429 with Retry-After; TTFT and
    TPOT are read from /v1/stats (host clock). Checks that the loop
    thread launches on the stream the pool's tensors were made on, and
    the launches. Returns the launches."""
    import asyncio
    import threading

    from repro_torch.launch.server import ServingFrontend
    from repro_torch.serving.driver import ServingDriver
    from repro_torch.serving.runtime import ModelInstancePool
    from repro_torch.serving.workload import (_read_chunked_events,
                                              http_generate,
                                              summarize_outcomes)

    def make_pool():
        pool = ModelInstancePool({cfg.name: cfg}, max_instances=1,
                                 max_slots=4, max_seq=640, kv_layout="paged",
                                 device=device)
        pool.load_params(cfg.name, params)
        pool.scale_to(cfg.name, 1)
        pool.warmup(seed=seed)
        return pool

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(8, 300, n_req).round().astype(int)]
    offline = make_pool()
    ids = [offline.submit(cfg.name, p, slo_ms=600_000.0,
                          max_new_tokens=max_new) for p in prompts]
    offline.run_until_drained()
    want = [r.tokens for r in _pool_tokens(offline, ids)]
    del offline

    pool = make_pool()
    eng = pool.running(cfg.name)[0].engine
    it0, ch0 = eng.n_iters, eng.n_prefill_chunks
    hold = _Hold(pool)
    submitted = {}
    submit = pool.submit

    def recording_submit(model, prompt, **kw):
        rid = submit(model, prompt, **kw)
        submitted[rid] = np.asarray(prompt)
        return rid
    pool.submit = recording_submit
    # the (thread, CUDA stream) every pool step ran on
    seen = set()
    step = pool.step

    def recording_step():
        seen.add((threading.get_ident(),
                  torch.cuda.current_stream(device).cuda_stream))
        return step()
    pool.step = recording_step
    main = (threading.get_ident(), torch.cuda.current_stream(
        device).cuda_stream)
    reset_launches()

    async def serve():
        with ServingDriver(pool) as driver:
            fe = ServingFrontend(driver, port=0, max_queue_depth=8)
            await fe.start()
            try:
                t0 = time.perf_counter()
                outs = await asyncio.wait_for(asyncio.gather(*(
                    http_generate("127.0.0.1", fe.port, cfg.name, p, max_new,
                                  600_000.0) for p in prompts)), HTTP_WAIT_S)
                wall = time.perf_counter() - t0
                stats = await _get_stats(fe.port)
                # a client hangs up after its first token; the pool is
                # held from that token on, so the request cannot finish
                # before the cancel lands
                hold.arm()
                reader, writer, status = await _raw_post(fe.port, {
                    "model": cfg.name, "max_new_tokens": 64,
                    "prompt": prompts[3].tolist(), "slo_ms": 600_000.0})
                if "200" not in status:
                    fail(f"http disconnect: status {status!r}")
                async for ev in _read_chunked_events(reader):
                    if ev.get("event") == "token":
                        break
                writer.close()
                t1 = time.perf_counter()
                while pool.n_cancelled < 1 \
                        and time.perf_counter() - t1 < HTTP_WAIT_S:
                    await asyncio.sleep(0.005)
                cancel_ms = (time.perf_counter() - t1) * 1e3
                with driver.lock:
                    kv_after = pool.kv_used_tokens(cfg.name)
                    live_after = eng.allocator.n_live
                hold.release()
                # 429: queue depth 1, the four slots pinned and held
                fe.max_queue_depth = 1
                hold.arm()
                for p in prompts[:4]:
                    driver.submit(cfg.name, p, slo_ms=600_000.0,
                                  max_new_tokens=64)
                await asyncio.get_running_loop().run_in_executor(
                    None, hold.held.wait, HTTP_WAIT_S)

                async def release_when_throttled():
                    t2 = time.perf_counter()
                    while fe.n_throttled < 1 \
                            and time.perf_counter() - t2 < HTTP_WAIT_S:
                        await asyncio.sleep(0.005)
                    hold.release()
                burst = await asyncio.wait_for(asyncio.gather(
                    release_when_throttled(), *(
                        http_generate("127.0.0.1", fe.port, cfg.name, p, 8,
                                      600_000.0) for p in prompts[4:])),
                    HTTP_WAIT_S)
                await asyncio.get_running_loop().run_in_executor(
                    None, driver.drain, HTTP_WAIT_S)
                return (outs, wall, stats, cancel_ms, kv_after, live_after,
                        burst[1:], fe)
            finally:
                await fe.stop()

    (outs, wall, stats, cancel_ms, kv_after, live_after, burst,
     fe) = asyncio.run(serve())
    pool.submit = submit
    del pool.step
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    want_l = _want(cfg, "paged", n_iters=n_iters, n_chunks=n_chunks,
                   n_slots=4, nb=40)
    if launches != want_l:
        fail(f"http: launches {launches} != {want_l}")
    if len(seen) != 1 or next(iter(seen))[0] == main[0] \
            or next(iter(seen))[1] != main[1]:
        fail(f"http: pool steps ran on (thread, stream) {seen}, the pool's "
             f"tensors were made on {main}")
    if [o.outcome for o in outs] != ["finished"] * n_req or any(
            o.n_tokens != max_new for o in outs):
        fail(f"http: outcomes {[(o.outcome, o.n_tokens) for o in outs]}")
    got = {r.request_id: r for r in pool.results(cfg.name)}
    streamed = sorted(rid for rid in submitted if rid in got
                      and not got[rid].cancelled)[:n_req]
    for rid in streamed:
        k = next(i for i, p in enumerate(prompts)
                 if np.array_equal(p, submitted[rid]))
        _hold_tie(torch, cfg, params, f"http request {rid}", prompts[k],
                  want[k], got[rid].tokens)
    if pool.stats()["n_cancelled"] != 1 or kv_after != 0 or live_after:
        fail(f"http disconnect: n_cancelled {pool.stats()['n_cancelled']}, "
             f"KV tokens after {kv_after}, live blocks {live_after}")
    throttled = [o for o in burst if o.outcome == "throttled"]
    if not throttled or not all(o.retry_after_s > 0 for o in throttled):
        fail("http backpressure: " + str(
            [(o.outcome, o.retry_after_s) for o in burst]))
    st = stats["stats"]
    summ = summarize_outcomes(outs)
    log(f"http {cfg.name}: {n_req} concurrent streams of {max_new} tokens "
        f"over one paged instance of 4 slots in {wall:.3f} s, every stream "
        f"equals the offline pool's; pool clock (host): TTFT ms p50 "
        f"{st['ttft_ms_p50']:.3f} p99 {st['ttft_ms_p99']:.3f}, TPOT ms p50 "
        f"{st['tpot_ms_p50']:.3f} p99 {st['tpot_ms_p99']:.3f}; client "
        f"(host): TTFT ms p50 {summ['ttft_ms_p50']:.3f} p99 "
        f"{summ['ttft_ms_p99']:.3f}, TPOT ms p50 {summ['tpot_ms_p50']:.3f} "
        f"[{smi}]")
    log(f"http disconnect: cancelled {cancel_ms:.1f} ms after the hang-up "
        f"(host clock), KV tokens and live blocks back to 0; burst of "
        f"{len(burst)} at queue depth 1: {len(throttled)} got 429, "
        f"Retry-After {[round(o.retry_after_s, 3) for o in throttled]} s, "
        f"{sum(o.outcome == 'finished' for o in burst)} finished; "
        f"frontend {fe.n_streamed} streamed, {fe.n_throttled} throttled, "
        f"{fe.n_disconnects} disconnects; the loop launched on the pool's "
        f"stream")
    log(f"http: launches {launches} == {want_l}")
    torch.cuda.empty_cache()
    return launches


def phase_sampling(torch, device, cfg, params, smi, max_new=16, seed=13):
    """Seeded sampling on the card: ``InferenceEngine.generate(greedy=
    False)`` repeats itself for one seed, differs across seeds, and its
    first token is greedy's. Returns the launches."""
    from repro_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(cfg, device=device, params=params)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 90, 200, 350)]
    reset_launches()
    greedy = eng.generate(prompts, max_new_tokens=max_new).tokens
    runs = [eng.generate(prompts, max_new_tokens=max_new, greedy=False,
                         seed=s).tokens for s in (0, 0, 1)]
    launches = read_launches()
    want = _want(cfg, "round", n_rounds=4, n_tokens=4 * max_new)
    if launches != want:
        fail(f"sampling: launches {launches} != {want}")
    if not np.array_equal(runs[0], runs[1]):
        fail("sampling: seed 0 drew different tokens twice")
    if np.array_equal(runs[0], runs[2]):
        fail("sampling: seeds 0 and 1 drew the same tokens")
    if not np.array_equal(runs[0][:, 0], greedy[:, 0]):
        fail("sampling: the first token is not greedy's")
    log(f"sampling {cfg.name}: b=4 rounds of {max_new} tokens: seed 0 "
        f"twice identical, seed 1 differs in "
        f"{int((runs[0] != runs[2]).sum())} of {runs[0].size} tokens, the "
        f"first tokens equal greedy's, {int((runs[0] != greedy).sum())} "
        f"sampled tokens differ from greedy [{smi}]")
    log(f"sampling: launches {launches} == {want}")
    del eng
    return launches


# ---------------------------------------------------------------- main
def phase_moe(torch, device, smi):
    """arctic-480b at its published widths cut to ``MOE_LAYERS`` layer,
    initialised on the card (never on the host) once every earlier model
    is freed: the paged continuous engine's drain (profiled) and round
    mode's six rounds, with exact launch counts. Returns the launches."""
    from repro_torch.config import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(MOE[0]), n_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name} cut to {cfg.n_layers} layer at full width (d "
        f"{cfg.d_model}, {cfg.n_experts} experts of {cfg.d_ff}, top-"
        f"{cfg.top_k}, dense residual {cfg.dense_ff}, capacity factor "
        f"{cfg.capacity_factor}): {n / 1e9:.2f} G params, "
        f"{n * 4 / 2**30:.1f} GiB, initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    launches = {name: 0 for name in REPLACES}
    for got in (phase_e2e(torch, device, cfg, params, smi, "paged")[0],
                phase_round(torch, device, cfg, params, smi)[0]):
        for name, k in got.items():
            launches[name] += k
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- families
#: the rope2d, M-RoPE / vision-frontend, windowed, llama-style and
#: encoder-decoder families at their published widths, one on the card at a
#: time: (arch, layers kept (None: all), round batch, continuous layouts,
#: max_seq). yi-34b's 60 layers are 137.6 GB in fp32, past the card's 80 GB: 16
#: are kept (39.4 GB). qwen2-vl's 1,024 frontend positions sit ahead of every
#: prompt, so its cache holds 2048. Seamless runs round mode only: the
#: continuous engine refuses encoder-decoder models, as the reference's.
FAMILIES = (("chatglm3-6b", None, 4, ("paged",), 640),
            ("qwen2-vl-7b", None, 2, ("paged", "dense"), 2048),
            ("starcoder2-15b", None, 4, ("dense",), 640),
            ("yi-34b", 16, 4, ("paged",), 640),
            ("seamless-m4t-large-v2", None, 4, (), 640))
#: a family drain: 8 requests of 16..500 prompt tokens, 8 new tokens
#: each (16 before PR 25, cut for time), 4 slots
FAMILY_REQ, FAMILY_NEW, FAMILY_SLOTS = 8, 8, 4


def _family_drain(torch, device, cfg, params, smi, kv_layout, max_seq,
                  seed=0):
    """The continuous engine at full width: ``FAMILY_REQ`` seeded requests
    drained through ``FAMILY_SLOTS`` slots, launches held to ``_want``
    (a frontend model's admissions are one-shot prefills), non-finite
    logits failing the run; then 4 resident sequences' decode iteration
    profiled three times (device busy against the drain's unprofiled
    decode p50: the idle share). Returns the launches."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    label = f"family {cfg.name} {kv_layout}"
    eng = ContinuousBatchingEngine(cfg, max_slots=FAMILY_SLOTS,
                                   max_seq=max_seq, kv_layout=kv_layout,
                                   token_budget=512, device=device,
                                   params=params)
    rng = np.random.default_rng(seed)
    eng.run([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
            max_new_tokens=2)  # warm-up: cuBLAS handles, kernel libraries
    lens = rng.permutation(np.linspace(16, 500, FAMILY_REQ).round().astype(
        int))
    bad = []
    _watch_logits(torch, eng.model, bad,
                  ("decode_step", "prefill_chunk", "prefill"))
    it0, ch0, ad0 = eng.n_iters, eng.n_prefill_chunks, eng.n_admitted
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for n in lens:
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=FAMILY_NEW)
    results, decode_ms = [], []
    t0 = time.perf_counter()
    while eng.waiting or eng.active_slots:
        before = (eng.n_prefill_chunk_tokens, eng.n_admitted)
        ts = time.perf_counter()
        results += eng.step()
        torch.cuda.synchronize()
        if (eng.n_prefill_chunk_tokens, eng.n_admitted) == before:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    n_inline = 0 if eng.chunked else eng.n_admitted - ad0
    nb = eng.blocks_per_slot if kv_layout == "paged" else 0
    want = _want(cfg, kv_layout, n_iters=n_iters, n_chunks=n_chunks,
                 n_inline=n_inline, n_slots=FAMILY_SLOTS, nb=nb)
    if len(results) != FAMILY_REQ or any(len(r.tokens) != FAMILY_NEW
                                         for r in results):
        fail(f"{label}: {len(results)} of {FAMILY_REQ} requests finished")
    if bool(torch.stack(bad).any()):
        fail(f"{label}: non-finite logits")
    if launches != want:
        fail(f"{label}: launches {launches} != {want} ({n_iters} decode "
             f"iterations, {n_chunks} chunks, {n_inline} one-shot "
             "prefills)")
    p50 = float(np.percentile(decode_ms, 50))
    log(f"{label}: {FAMILY_REQ} requests (prompts {int(lens.min())}.."
        f"{int(lens.max())}), {n_iters} decode iterations, {n_chunks} "
        f"chunks, {n_inline} one-shot prefills, wall {wall:.3f} s, "
        f"{FAMILY_REQ * FAMILY_NEW / wall:.1f} generated tokens/s, "
        f"decode-only iteration ms p50 {p50:.3f} p99 "
        f"{np.percentile(decode_ms, 99):.3f} (n={len(decode_ms)}), max "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{smi}]")
    log(f"{label}: launches {launches} == {want}")
    for n in (100, 200, 300, 400):
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=24)
    while eng.waiting or eng.prefill_backlog_tokens:
        eng.step()

    def three():
        for _ in range(3):
            eng.step()
    wall, busy, nk, names = _profiled(torch, three)
    _report_profile([("decode-only step", 3, wall, busy, nk, names)], smi,
                    label)
    log(f"{label}: decode-only device busy {busy / 3:.3f} ms of the "
        f"unprofiled p50 {p50:.3f} ms per iteration: idle share "
        f"{1 - busy / 3 / p50:.1%} [{smi}]")
    del eng
    torch.cuda.empty_cache()
    return launches


def _family_round(torch, device, cfg, params, smi, b, max_new=16, seed=0):
    """Round mode at full width: one warm-up, then one round of ``b``
    prompts of 16..500 tokens (bucket 512), ``max_new`` tokens each,
    launches held to ``_want`` and logits finite. Returns the
    launches."""
    from repro_torch.serving.engine import InferenceEngine

    label = f"family {cfg.name} round b={b}"
    eng = InferenceEngine(cfg, device=device, params=params)
    rng = np.random.default_rng(seed + 7)
    eng.generate([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
                 max_new_tokens=2)
    bad = []
    _watch_logits(torch, eng.model, bad, ("prefill", "decode_step"))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(16, 500, b).round().astype(int)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = eng.generate(prompts, max_new_tokens=max_new)
    launches = read_launches()
    want = _want(cfg, "round", n_rounds=1, n_tokens=max_new)
    if res.tokens.shape != (b, max_new) or bool(torch.stack(bad).any()):
        fail(f"{label}: tokens {res.tokens.shape} or non-finite logits")
    if launches != want:
        fail(f"{label}: launches {launches} != {want}")
    log(f"{label}: prefill {res.prefill_ms:.1f} ms, decode "
        f"{res.decode_ms / max_new:.3f} ms/token, "
        f"{b * max_new / res.total_ms * 1e3:.1f} generated tokens/s, max "
        f"memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches} == {want} [{smi}]")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_families(torch, device, smi):
    """Each family of ``FAMILIES`` at its published widths, one on the
    card at a time (every earlier model freed): params drawn on the card,
    round mode and its continuous layouts, launches checked. Returns the
    launches summed."""
    from repro_torch.config import get_config
    from repro_torch.models.transformer import init_params

    launches = {name: 0 for name in REPLACES}

    def add(got):
        for name, k in got.items():
            launches[name] += k

    for arch, layers, b, layouts, max_seq in FAMILIES:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            log(f"family {arch}: cut to {layers} of {cfg.n_layers} layers "
                f"(the full depth, {cfg.param_count_estimate() * 4 / 1e9:.1f}"
                " GB of fp32 weights, does not fit the card's 80 GB)")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        log(f"family {arch}: L={cfg.n_layers} (+{cfg.n_enc_layers} encoder)"
            f" d={cfg.d_model} heads ({cfg.n_heads},{cfg.n_kv_heads},"
            f"{cfg.head_dim}) rope {cfg.rope} window {cfg.sliding_window} "
            f"frontend {cfg.frontend} ({cfg.frontend_tokens} tokens): "
            f"{n / 1e9:.2f} G params, {n * 4 / 1e9:.1f} GB, initialised on "
            f"the card in {time.perf_counter() - t0:.1f} s [{smi}]")
        add(_family_round(torch, device, cfg, params, smi, b))
        for layout in layouts:
            add(_family_drain(torch, device, cfg, params, smi, layout,
                              max_seq))
        del params
        torch.cuda.empty_cache()
        log(f"time: family {arch} {time.perf_counter() - t_arch:.1f} s")
    return launches


#: card vs CPU, the edge nets' outputs: fp32 convolutions summed in
#: another order (cuDNN's algorithms against the CPU's), relative to the
#: output's scale
EDGE_TOL = 1e-3
#: the edge nets' ``width``: each stem at its published net's channels.
#: ResNet-18 at 64, which the reference names the true ResNet-18 (stages
#: 64..512); MobileNetV3-Large's stem of 16; EfficientNet-B0's of 32;
#: Inception-v3's first convolution of 32 (the stem is 2 x width); YOLOv5s's
#: 6 x 6 stem of 32 (stages 64, 128, 256). The blocks past the stem are the
#: reference's compact ones (PERF.md section 4)
EDGE_WIDTHS = {"res": 64, "mob": 16, "eff": 32, "inc": 16, "yolo": 32}


def phase_edge(torch, device, smi, seed=0):
    """The paper's edge nets (Table IV) at ``EDGE_WIDTHS`` and its
    224 x 224 input, batch 1 and 8, on the card and on the CPU with the
    same params: outputs
    within ``EDGE_TOL`` of the CPU's relative to their scale and the same
    top class per image (unless the CPU's top two are within 1e-5), card
    forward ms (CUDA events, mean of 10). Then TinyBERT (the trunk at hd
    64, causal) on 14-token utterances, whose forward on the card must
    launch ``flash_attention`` once per layer. Returns TinyBERT's
    launches."""
    from repro_torch.device import to_device
    from repro_torch.models import cnn

    rng = np.random.default_rng(seed)

    def agree(label, got, want, classify=True):
        got, want = got.float().cpu(), want.float()
        if not torch.isfinite(got).all():
            fail(f"edge {label}: non-finite output on the card")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not err <= EDGE_TOL * max(scale, 1.0):
            fail(f"edge {label}: card vs CPU max abs err {err:.3e} (output "
                 f"scale {scale:.3e})")
        note = ""
        if classify:
            top2 = torch.topk(want, 2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) < 1e-5
            same = got.argmax(-1) == want.argmax(-1)
            if not bool((same | tie).all()):
                fail(f"edge {label}: top class differs beyond a tie")
            note = f", top class equal on {int(same.sum())} of {len(same)}"
        return err, scale, note

    for name, (init, apply) in cnn.EDGE_NETS.items():
        p_cpu = init(seed=seed, width=EDGE_WIDTHS[name], device="cpu")
        p_dev = to_device(p_cpu, device)
        n = sum(t.numel() for t in _leaves(p_cpu) if hasattr(t, "numel"))
        for B in (1, 8):
            x = rng.standard_normal((B, 224, 224, 3)).astype(np.float32)
            xd = torch.from_numpy(x).to(device)
            got = apply(p_dev, xd)
            want = apply(p_cpu, torch.from_numpy(x))
            err, scale, note = agree(f"{name} b={B}", got, want,
                                     classify=name != "yolo")
            ms = _time_ms(torch, lambda i: apply(p_dev, xd), 1, iters=10)
            log(f"edge {name} width {EDGE_WIDTHS[name]} b={B}: output "
                f"{tuple(got.shape)}, card vs CPU "
                f"max abs err {err:.3e} (scale {scale:.3e}){note}; "
                f"{n / 1e6:.2f} M params, card forward {ms:.3f} ms "
                f"[{smi}]")
    p_cpu, cfg = cnn.tinybert_init(seed=seed, device="cpu")
    p_dev = to_device(p_cpu, device)
    launches = {name: 0 for name in REPLACES}
    for B in (1, 8):
        toks = rng.integers(0, cfg.vocab_size, (B, 14)).astype(np.int32)
        reset_launches()
        got = cnn.tinybert_apply((p_dev, cfg), torch.from_numpy(toks).to(
            device))
        n_launch = read_launches()
        want = {k: 0 for k in REPLACES}
        want["flash_attention"] = cfg.n_layers
        if n_launch != want:
            fail(f"edge tinybert b={B}: launches {n_launch} != {want}")
        for k, v in n_launch.items():
            launches[k] += v
        err, scale, note = agree(f"tinybert b={B}", got, cnn.tinybert_apply(
            (p_cpu, cfg), torch.from_numpy(toks)))
        log(f"edge tinybert b={B}: (L={cfg.n_layers}, d={cfg.d_model}, "
            f"heads {cfg.n_heads} of {cfg.head_dim}) logits "
            f"{tuple(got.shape)}, card vs CPU max abs err {err:.3e}{note}; "
            f"launches {n_launch} [{smi}]")
    return launches


# ---------------------------------------------------------------- phase sim
#: the simulator path at the CLI's defaults (the six Table-IV models on
#: Xavier NX at 30 requests/s per model, SAC at batch 256 and lr 5e-4,
#: the NN predictor as the guard): simulated ms of each learning episode
#: and of each baseline's
SIM_EPISODE_MS = 20_000.0
SIM_BASELINE_MS = 10_000.0
#: relative gap the card's and the CPU's guard predictions may have where
#: a verdict flips (a near-tie); the greedy logit margin of a shown tie
SIM_TIE = 2e-4
SIM_MARGIN = 1e-4


class _TimedAgent:
    """An agent whose ``act`` and ``update`` are timed on the host clock
    between ``torch.cuda.synchronize`` calls (an update's ms are kept only
    when it ran). Given an ``events`` list it acts greedily and appends
    (``"act"``, state, action, top-two logit margin, simulated ms) for
    each action, ``env`` supplying the time."""

    def __init__(self, torch, agent, env=None, events=None):
        self.torch, self.agent, self.env, self.events = \
            torch, agent, env, events
        self.act_ms, self.update_ms = [], []

    def act(self, s, greedy=False):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = self.agent.act(s, greedy=self.events is not None)
        torch.cuda.synchronize()
        self.act_ms.append((time.perf_counter() - t0) * 1e3)
        if self.events is not None:
            with torch.no_grad():
                logits = self.agent.policy(torch.as_tensor(
                    s, dtype=torch.float32, device=self.agent.device))
            top2 = np.sort(logits.cpu().double().numpy())[-2:]
            self.events.append(("act", np.asarray(s).copy(), a,
                                float(top2[1] - top2[0]), self.env.now))
        return a

    def observe(self, *t):
        self.agent.observe(*t)

    def update(self):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = self.agent.update()
        torch.cuda.synchronize()
        if m:
            self.update_ms.append((time.perf_counter() - t0) * 1e3)
        return m


def _trace_predictions(pred, env, events):
    """Record every guard prediction: (``"pred"``, features, value, None,
    simulated ms)."""
    inner = pred.predict

    def predict(feats):
        y = inner(feats)
        events.append(("pred", np.asarray(feats).copy(), y, None, env.now))
        return y

    pred.predict = predict


def _first_divergence(a, b):
    """(index of the first event whose kind, input or action differs, the
    index of the event that caused it), or None for identical traces: an
    act whose action differs is its own cause, an input that differs
    blames the event before it (a guard verdict)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0] or not np.array_equal(x[1], y[1]):
            return i, i - 1
        if x[0] == "act" and x[2] != y[2]:
            return i, i
    if len(a) != len(b):
        n = min(len(a), len(b))
        return n, n - 1
    return None


def _baseline_update_ms(torch, agent, calls=5):
    """ms of each of ``calls`` updates of a learning baseline at its own
    mini-batch (TAC, DDQN: 512 from the replay; PPO: a 256-step rollout,
    4 epochs), its replay or rollout topped up with copies of the
    transitions its episode recorded: a 10 s episode holds fewer."""
    rows = list(getattr(agent, "buf", []))
    ms = []
    for _ in range(calls):
        if hasattr(agent, "replay"):
            r, n = agent.replay, len(agent.replay)
            for i in range(max(0, agent.batch_size - n)):
                j = i % n
                agent.observe(r.s[j], r.a[j], r.r[j], r.s2[j], r.done[j])
        else:
            agent.buf = (rows * (agent.horizon // len(rows) + 1))[
                :agent.horizon]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = agent.update()
        torch.cuda.synchronize()
        if not m:
            fail(f"sim: baseline {agent.name} did not update")
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _on_cuda(torch, label, modules, tensors=()):
    """Fail unless every parameter of ``modules`` and every tensor in
    ``tensors`` lies on the card."""
    where = {p.device.type for m in modules for p in m.parameters()}
    where |= {t.device.type for t in tensors}
    if where != {"cuda"}:
        fail(f"sim: {label} has parameters on {sorted(where)}, not the card")


def _sim_episode(torch, smi, label, env, agent, pred=None, guard=True,
                 learn=True):
    """One ``run_episode`` through a timed agent; logs the episode's
    figures and fails unless requests are conserved. Returns the result
    and the timed agent."""
    from repro_torch.serving.bcedge import run_episode

    timed = agent if isinstance(agent, _TimedAgent) else \
        _TimedAgent(torch, agent)
    n_act, n_upd = len(timed.act_ms), len(timed.update_ms)
    pred_ms = []
    if pred is not None:  # time each guard prediction, readback included
        inner = pred.predict

        def predict(feats):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = inner(feats)
            torch.cuda.synchronize()
            pred_ms.append((time.perf_counter() - t) * 1e3)
            return y

        pred.predict = predict
    t0 = time.perf_counter()
    try:
        res = run_episode(env, timed, pred, guard=guard, learn=learn)
    finally:
        if pred is not None:
            pred.predict = inner
    wall = time.perf_counter() - t0
    s = res.summary
    served = sum(r.n_requests for r in env.history)
    queued = sum(len(q) for q in env.queues.values())
    dropped = sum(q.dropped for q in env.queues.values())
    in_flight = sum(p.n_requests if k == "complete" else
                    len(p.active) + len(p.done)
                    for _, _, k, p in env._events if k in ("complete",
                                                           "iter"))
    if served + queued + in_flight + dropped != env.total_requests or \
            not served:
        fail(f"sim {label}: {env.total_requests} arrived, {served} served "
             f"+ {queued} queued + {in_flight} in flight + {dropped} "
             "dropped")
    n = len(res.overhead_ms)
    act_ms, update_ms = timed.act_ms[n_act:], timed.update_ms[n_upd:]

    def mean(xs):
        return f"{np.mean(xs):.3f}" if xs else "none"

    log(f"sim {label}: {n} decisions in {wall:.1f} s wall, utility "
        f"{s['mean_utility']:.4f}, throughput {s['throughput_rps']:.2f} "
        f"rps, goodput {s['goodput_rps']:.2f} rps, violation rate "
        f"{s['slo_violation_rate']:.4f}, {env.total_requests} arrived = "
        f"{served} served + {queued} queued + {in_flight} in flight + "
        f"{dropped} dropped; ms per decision {np.mean(res.overhead_ms):.3f}"
        f" (p50 {np.percentile(res.overhead_ms, 50):.3f}, p99 "
        f"{np.percentile(res.overhead_ms, 99):.3f}); act ms "
        f"{mean(act_ms)} over {len(act_ms)}, update ms {mean(update_ms)} "
        f"over {len(update_ms)}, guard predict ms {mean(pred_ms)} over "
        f"{len(pred_ms)} [{smi}]")
    return res, timed


def phase_sim(torch, device, smi):
    """The simulator path (``EdgeServingEnv``, ``run_episode``, the
    ``BCEdgeScheduler`` guard) at the CLI's defaults, agents and predictor
    on the card: two learning round-mode episodes and one continuous
    (6 decode iterations a request) of SAC with the guard, one episode of
    each baseline, the CLI itself, then a greedy episode with learning
    off on the card against the same nets on the CPU (the same schedule,
    or a shown near-tie). No TPU kernel lies on this path; the launch
    counts read 0. Returns them."""
    from repro_torch.config.base import ServingConfig
    from repro_torch.core import baselines as bl
    from repro_torch.core.interference import NNInterferencePredictor
    from repro_torch.core.sac import NETS, SACAgent, SACConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.features import queue_feature_index, state_dim
    from repro_torch.serving.simulator import EdgeServingEnv

    reset_launches()
    t_phase = time.perf_counter()
    cfg = ServingConfig()
    models = EdgeServingEnv(cfg, episode_ms=1.0).models
    dim = state_dim(models)

    def sac_and_guard():
        agent = SACAgent(dim, cfg.n_actions,
                         SACConfig(batch_size=256, lr=5e-4), device=device)
        pred = NNInterferencePredictor(device=device)
        _on_cuda(torch, "SAC + predictor",
                 [getattr(agent, n) for n in NETS] + [pred.net],
                 [agent.log_alpha])
        return agent, pred

    log(f"sim: {len(models)} models {models} on {cfg.platform} at "
        f"{cfg.arrival_rps} rps each, {cfg.n_actions} actions, state "
        f"{dim}; SAC batch 256, lr 5e-4; NN predictor guard; agents on "
        f"{torch.cuda.get_device_name(device)}")
    agent, pred = sac_and_guard()
    timed = _TimedAgent(torch, agent)
    for ep in range(2):
        env = EdgeServingEnv(cfg, episode_ms=SIM_EPISODE_MS, seed=ep)
        _sim_episode(torch, smi, f"SAC round ep{ep}", env, timed, pred)
    if not timed.update_ms:
        fail("sim: SAC never updated in two episodes")
    log(f"sim: SAC act ms p50 {np.percentile(timed.act_ms, 50):.3f}, "
        f"update ms p50 {np.percentile(timed.update_ms, 50):.3f} (batch "
        f"256, {len(timed.update_ms)} updates) [{smi}]")
    trained = agent
    ccfg = ServingConfig(exec_mode="continuous", decode_steps_mean=6.0)
    agent_c, pred_c = sac_and_guard()
    _sim_episode(torch, smi, "SAC continuous (decode 6)",
                 EdgeServingEnv(ccfg, episode_ms=SIM_EPISODE_MS, seed=0),
                 agent_c, pred_c)

    qi = queue_feature_index(models)
    learned = {"tac": bl.TACAgent(dim, cfg.n_actions, device=device),
               "ppo": bl.PPOAgent(dim, cfg.n_actions, device=device),
               "ddqn": bl.DDQNAgent(dim, cfg.n_actions, device=device)}
    for name, a in learned.items():
        _on_cuda(torch, name, [getattr(a, n) for n in a.NETS])
    heuristics = {
        "ga": bl.GAScheduler(dim, cfg.n_actions),
        "edf": bl.EDFScheduler(cfg.batch_sizes, cfg.concurrency_levels, qi,
                               n_models=len(models),
                               arrival_rps=cfg.arrival_rps,
                               platform=cfg.platform),
        "fixed": bl.FixedScheduler(cfg.pair_to_action(4, 2))}
    for name, a in {**learned, **heuristics}.items():
        _sim_episode(torch, smi, f"baseline {name}",
                     EdgeServingEnv(cfg, episode_ms=SIM_BASELINE_MS, seed=0),
                     a, guard=False)
    for name, a in learned.items():
        ms = _baseline_update_ms(torch, a)
        log(f"sim baseline {name}: update ms at its own batch "
            f"{np.mean(ms):.3f} (p50 {np.percentile(ms, 50):.3f}, {len(ms)} "
            f"updates) [{smi}]")

    t0 = time.perf_counter()
    serve_cli.main(["--episodes", "1", "--episode-ms", "3000"])
    log(f"sim: the CLI's default (simulator, cuda) ran one 3000 ms episode "
        f"in {time.perf_counter() - t0:.1f} s")

    # greedy, learning off: the trained SAC nets on the card and copied to
    # the CPU, each with a fresh predictor made from one net, traced
    card_pred = NNInterferencePredictor(device=device)
    cpu_agent = SACAgent(dim, cfg.n_actions,
                         SACConfig(batch_size=256, lr=5e-4), device="cpu")
    nets = {n: {k: v.cpu() for k, v in getattr(trained, n).state_dict()
                .items()} for n in NETS}
    nets["log_alpha"] = trained.log_alpha.detach().cpu()
    cpu_agent.load_nets(nets)
    cpu_pred = NNInterferencePredictor(device="cpu")
    cpu_pred.load_net({k: v.cpu() for k, v in
                       card_pred.net.state_dict().items()})
    runs = {}
    for where, a, p in (("card", trained, card_pred),
                        ("cpu", cpu_agent, cpu_pred)):
        env = EdgeServingEnv(cfg, episode_ms=SIM_BASELINE_MS, seed=7)
        events = []
        _trace_predictions(p, env, events)
        _sim_episode(torch, smi, "SAC greedy, learning off, "
                              f"{where}", env,
                              _TimedAgent(torch, a, env, events), p,
                              learn=False)
        runs[where] = (env, events)
    (c_env, c_ev), (h_env, h_ev) = runs["card"], runs["cpu"]
    div = _first_divergence(c_ev, h_ev)
    t_cut = float("inf")
    if div is not None:
        at, cause = div
        x, y = c_ev[cause], h_ev[cause]
        if x[0] == "act":
            if min(x[3], y[3]) >= SIM_MARGIN:
                fail(f"sim parity: greedy actions differ at event {cause} "
                     f"({x[2]} vs {y[2]}), logit margin {x[3]:.3e}")
            note = f"greedy action near-tie, logit margin {x[3]:.3e}"
        else:
            gap = abs(x[2] - y[2]) / y[2]
            if gap >= SIM_TIE:
                fail(f"sim parity: guard verdicts differ at event {cause}, "
                     f"predictions {x[2]} vs {y[2]} (gap {gap:.3e})")
            note = (f"guard near-tie, predictions {x[2]:.6g} vs {y[2]:.6g}"
                    f" (gap {gap:.3e})")
        t_cut = x[4]
        log(f"sim parity: first difference at event {at} of {len(c_ev)} "
            f"(t = {t_cut:.1f} ms): {note}")
    keep = [(r.model, r.b, r.m_c, r.n_requests, r.decision_ms, r.finish_ms,
             r.utility) for r in h_env.history if r.decision_ms < t_cut]
    got = [(r.model, r.b, r.m_c, r.n_requests, r.decision_ms, r.finish_ms,
            r.utility) for r in c_env.history if r.decision_ms < t_cut]
    if got != keep or len(got) < 20:
        fail(f"sim parity: {len(got)} card rounds vs {len(keep)} CPU rounds "
             "before the first difference, not the same schedule")
    preds = [(x[2], y[2]) for x, y in zip(c_ev, h_ev)
             if x[0] == y[0] == "pred"]
    gap = max((abs(x - y) / y for x, y in preds), default=0.0)
    log(f"sim parity: greedy episode, learning off, card vs CPU: "
        f"{len(got)} rounds identical{' (whole episode)' if div is None else ''}"
        f", {len(c_ev)} traced events, {len(preds)} guard predictions "
        f"within {gap:.3e} relative, smallest logit margin "
        f"{min(e[3] for e in c_ev if e[0] == 'act'):.3e}")
    got = read_launches()
    if any(got.values()):
        fail(f"sim: the simulator path launched kernels {got}")
    log(f"sim: {time.perf_counter() - t_phase:.1f} s; launches {got} (no "
        f"TPU kernel lies on this path) [{smi}]")
    return got


# ---------------------------------------------------------------- training
#: qwen3-0.6b at full width through ``repro_torch.launch.train``'s code
#: path, at the reference TrainerConfig's batch 8 and sequence 256
#: (warmup 50, so the learning rate ramps to 20/50 of its peak)
TRAIN_STEPS = 20
TRAIN_ARGS = ("--arch", FULL, "--batch", "8", "--seq", "256", "--steps",
              str(TRAIN_STEPS), "--lr", "1e-3")
#: recurrentgemma-2b at full width, 2 steps: the reversed RG-LRU scan at
#: its published width (2.9 G params hold 46 GB in fp32 with Adam, so
#: batch 4)
TRAIN_RG_ARGS = ("--arch", "recurrentgemma-2b", "--batch", "4", "--seq",
                 "256", "--steps", "2")
#: card against CPU on the reduced configs, the same params and batch:
#: the loss to 1e-5 relative; each gradient leaf's max |diff| over its max
#: |CPU grad| to 1e-2. Reduced rwkv6-3b's loss is ill-conditioned at these
#: params: on the CPU its fp32 gradients lie up to 2.2e-3 from the float64
#: ones, and a 1e-6 relative change of the params moves them by 1.5e-2;
#: the other configs agree to about 1e-6. A gradient the card dropped
#: differs by 1.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-2


def _train_launches(cfg, steps, remat=False):
    """Kernel launches of ``steps`` loss-and-backward passes of ``cfg``:
    flash once per attention layer (twice with ``remat``, the forward
    recomputed; an encoder-decoder layer's cross attention too, and the
    encoder's layers once), the RG-LRU scan once forward and once
    reversed, RWKV-6 once (its backward is torch ops), the expert GEMM
    three times forward and six backward."""
    kinds = cfg.layer_kinds()
    r = 2 if remat else 1
    n_attn = sum(k not in ("rglru", "rwkv") for k in kinds)
    n_moe = sum(k not in ("rwkv", "attn_dense") for k in kinds) \
        if cfg.n_experts else 0
    flash = n_attn * r * (2 if cfg.enc_dec else 1) + (
        cfg.n_enc_layers if cfg.enc_dec else 0)
    want = {name: 0 for name in REPLACES}
    want.update(flash_attention=flash * steps,
                rglru_scan=kinds.count("rglru") * (r + 1) * steps,
                rwkv6_scan=kinds.count("rwkv") * r * steps,
                moe_matmul=n_moe * (3 * r + 6) * steps)
    return want


def _check_train_launches(label, got, want):
    if got != want:
        fail(f"train {label}: launches {got}, expected {want}")
    log(f"train {label}: launches exact "
        f"{ {k: n for k, n in got.items() if n} }")


def _train_run(torch, device, argv, label):
    """A trainer from the launcher's own parser and constructor, run for
    its steps with the launches counted. Returns (trainer, stats,
    launches, run seconds)."""
    from repro_torch.launch import train as lt

    t0 = time.perf_counter()
    tr = lt.make_trainer(lt.parse_args(list(argv)))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(tr.state.params))
    log(f"train {label}: {n / 1e9:.3f} G params, trainer built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reset_launches()
    t0 = time.perf_counter()
    stats = tr.run(log=lambda line: log(f"train {label}: {line}"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = read_launches()
    log(f"train {label}: final loss: {stats['final_loss']:.4f} "
        f"({tr.tcfg.steps} steps in {run_s:.2f} s)")
    if not all(np.isfinite(v) for v in stats.values()):
        fail(f"train {label}: non-finite loss {stats}")
    return tr, stats, got, run_s


def phase_train(torch, device, smi):
    """Training on the card: full-width qwen3-0.6b 20 steps through the
    launcher (the loss on a held-out batch must fall; exact flash
    launches, then one ``remat=True`` step; ms a step, tokens/s, one
    profiled step, peak memory), full-width recurrentgemma-2b 2 steps,
    the ten reduced configs card against CPU, and a checkpoint round
    trip. Returns the launches of the two full-width runs."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params
    from repro_torch.train.data import TokenPipeline

    launches = {name: 0 for name in REPLACES}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    torch.cuda.reset_peak_memory_stats(device)
    tr, stats, got, run_s = _train_run(torch, device, TRAIN_ARGS, FULL)
    cfg, tcfg = tr.cfg, tr.tcfg
    add(got)
    _check_train_launches(FULL, got, _train_launches(cfg, TRAIN_STEPS))
    # the last step's batch (the trainer's pipeline replayed) and a
    # held-out one, each under the initial params (rebuilt from the seed)
    # and the trained ones
    replay = tr.data()
    for _ in range(TRAIN_STEPS):
        last = replay.sample_batch()
    pipe = TokenPipeline(cfg.vocab_size, tcfg.seq_len, tcfg.batch,
                         seed=tcfg.seed + 1)
    batches = {"the last step's batch": tr.to_batch(last),
               "a held-out batch": tr.to_batch(pipe.sample_batch())}
    init = init_params(cfg, tcfg.seed, device=device)
    with torch.no_grad():
        evals = {what: [float(tr.model.loss(p, b))
                        for p in (init, tr.state.params)]
                 for what, b in batches.items()}
    del init, batches
    for what, (before, after) in evals.items():
        log(f"train {FULL}: loss on {what}, initial params {before:.4f}, "
            f"after {TRAIN_STEPS} steps {after:.4f}")
    log(f"train {FULL}: run losses {stats['first_loss']:.4f} -> "
        f"{stats['final_loss']:.4f}")
    before, after = evals["the last step's batch"]
    if not after < before:
        fail(f"train {FULL}: the loss did not fall ({before:.4f} -> "
             f"{after:.4f})")
    tokens = tcfg.batch * tcfg.seq_len

    def step():
        tr.state, _ = tr._step(tr.state, tr.to_batch(pipe.sample_batch()))

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    wall, busy, n, names = _profiled(torch, step)
    _report_profile([("one step", 1, wall, busy, n, names)], smi,
                    f"train {FULL}")
    _flash_share(torch, device, cfg, tcfg, busy, smi)
    tr.model = build_model(cfg, remat=True)
    reset_launches()
    step()
    torch.cuda.synchronize()
    got = read_launches()
    add(got)
    _check_train_launches(f"{FULL} remat=True step", got,
                          _train_launches(cfg, 1, remat=True))
    peak = torch.cuda.max_memory_allocated(device)
    log(f"train {FULL}: {step_s * 1e3:.1f} ms a step (median of 3 "
        f"synchronised steps; the 20-step run {run_s * 1e3 / TRAIN_STEPS:.1f}"
        f" ms a step), {tokens / step_s:,.0f} tokens/s; profiled step: "
        f"device busy {busy:.1f} ms of {wall * 1e3:.1f} ms wall, idle "
        f"{1 - busy / (wall * 1e3):.1%}; peak memory {peak / 2**30:.2f} "
        f"GiB [{smi}]")
    del tr
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    tr, stats, got, run_s = _train_run(torch, device, TRAIN_RG_ARGS,
                                       TRAIN_RG_ARGS[1])
    add(got)
    _check_train_launches(TRAIN_RG_ARGS[1], got,
                          _train_launches(tr.cfg, tr.tcfg.steps))
    log(f"train {TRAIN_RG_ARGS[1]}: {run_s * 1e3 / tr.tcfg.steps:.1f} ms a "
        f"step (first step included), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB [{smi}]")
    del tr
    torch.cuda.empty_cache()
    _train_parity(torch, device)
    _train_checkpoint(torch, device)
    return launches


def _flash_share(torch, device, cfg, tcfg, busy, smi):
    """Event ms of flash's forward kernel and of its torch-op backward at
    the training step's shape, and their share of the step's device
    busy (the backward's GEMMs carry cuBLAS's names in a profile)."""
    from repro_torch.kernels import flash_attention as fl

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    B, S, H, KV, hd = (tcfg.batch, tcfg.seq_len, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    q = torch.randn((B, S, H, hd), generator=gen, device=device)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=device)
             for _ in range(2))
    kw = dict(scale=hd ** -0.5, causal=True)
    out = fl.flash_attention_launch(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device=device)
    fwd = _time_ms(torch, lambda i: fl.flash_attention_launch(q, k, v, **kw),
                   1)
    bwd = _time_ms(torch, lambda i: fl.flash_attention_backward(
        q, k, v, out, dout, **kw), 1)
    n = sum(k not in ("rglru", "rwkv") for k in cfg.layer_kinds())
    log(f"train {FULL}: flash at q ({B},{S},{H},{hd}): forward kernel "
        f"{fwd:.3f} ms, torch-op backward {bwd:.3f} ms (events); {n} "
        f"layers: {n * fwd:.1f} + {n * bwd:.1f} ms, "
        f"{n * (fwd + bwd) / busy:.1%} of the step's device busy [{smi}]")


def _train_batch(torch, cfg, B=2, S=32, seed=0):
    """``tests/test_arch_smoke.py``'s ``make_batch``: tokens and labels,
    plus frontend or frame embeddings where the config has them."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.enc_dec:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, max(8, S // 4), cfg.d_model)) * 0.1
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    elif cfg.frontend is not None:
        F = cfg.frontend_tokens
        batch["frontend_embeds"] = rng.standard_normal(
            (B, F, cfg.d_model)) * 0.1
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - F))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    batch["labels"] = rng.integers(0, cfg.vocab_size,
                                   batch["tokens"].shape)
    return {k: torch.from_numpy(v.astype(
        np.float32 if k == "frontend_embeds" else np.int32))
        for k, v in batch.items()}


def _train_parity(torch, device):
    """Each reduced assigned config's loss and every gradient leaf on the
    card against the CPU, the same params and batch; the card's launches
    exact. The check that catches a gradient the card dropped."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.config import get_reduced_config
    from repro_torch.configs import ASSIGNED
    from repro_torch.device import to_device
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params

    for arch in ASSIGNED:
        cfg = get_reduced_config(arch)
        model = build_model(cfg, remat=False)
        res = {}
        for dev in ("cpu", device):
            params = to_device(init_params(cfg, seed=0, device="cpu"), dev)
            paths, leaves = zip(*flatten_with_paths(params))
            for p in leaves:
                p.requires_grad_(True)
            reset_launches()
            loss = model.loss(params, to_device(_train_batch(torch, cfg),
                                                dev))
            grads = torch.autograd.grad(loss, leaves)
            res[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        read_launches())
        (lc, gc, _), (lg, gg, got) = res["cpu"], res[device]
        _check_train_launches(f"{arch} (reduced)", got,
                              _train_launches(cfg, 1))
        loss_err = abs(lg - lc) / abs(lc)
        worst, where = max((float((g - c).abs().max())
                            / max(float(c.abs().max()), 1e-30), path)
                           for g, c, path in zip(gg, gc, paths))
        log(f"train {arch} (reduced): loss card {lg:.6f} cpu {lc:.6f} "
            f"(rel {loss_err:.2e}, tolerance {TRAIN_LOSS_RTOL:g}); "
            f"{len(gc)} gradient leaves, worst max |diff| / max |cpu| "
            f"{worst:.2e} at {where} (tolerance {TRAIN_GRAD_TOL:g})")
        if not (loss_err <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
            fail(f"train {arch} (reduced): card and CPU disagree")


def _train_checkpoint(torch, device):
    """A reduced trainer's checkpoint (its ``ckpt_path``) and its whole
    train state (the optimizer's NamedTuples included) saved from the
    card, loaded and restored onto the card bit for bit."""
    import shutil

    from repro_torch.common.tree import tree_leaves
    from repro_torch.config import get_reduced_config
    from repro_torch.train.checkpoint import (load_checkpoint, restore_like,
                                              save_checkpoint)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    out = ROOT / "build" / "train_ckpt"
    path = out / "lm.npz"
    try:
        tr = Trainer(get_reduced_config(FULL), TrainerConfig(
            batch=2, seq_len=64, steps=2, log_every=1000,
            ckpt_path=str(path)), device=device)
        tr.run(log=lambda *_: None)
        loaded = load_checkpoint(str(path))
        if loaded["__meta__"].get("steps") != 2:
            fail(f"checkpoint: metadata {loaded['__meta__']}")
        save_checkpoint(str(out / "state.npz"), tr.state,
                        {"step": int(tr.state.step)})
        for what, tree, back in (
                ("params", tr.state.params,
                 restore_like(tr.state.params, loaded)),
                ("train state", tr.state, restore_like(
                    tr.state, load_checkpoint(str(out / "state.npz"))))):
            pairs = list(zip(tree_leaves(tree), tree_leaves(back)))
            for a, b in pairs:
                if a.device != b.device or a.dtype != b.dtype \
                        or not torch.equal(a.detach(), b):
                    fail(f"checkpoint {what}: a leaf did not round-trip")
            if type(back) is not type(tree):
                fail(f"checkpoint {what}: {type(back)} restored")
            log(f"checkpoint {what}: {len(pairs)} leaves saved from the "
                f"card and restored onto it bit for bit ({type(back).__name__})")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run(torch, device, smi):
    """Every phase after the build: kernels vs plain, timing, the three
    serving paths of full-width qwen3-0.6b, its online path (preemption,
    HTTP, seeded sampling), its prefix cache, speculative decoding and
    the host KV tier, then the dense
    continuous engine and round mode of each full-width recurrent family
    and the paged engine and round mode of arctic-480b cut to one layer,
    then the families of ``FAMILIES`` (one model on the card at a time),
    card-vs-CPU parity at reduced width, and the edge nets.
    Returns the result line's kernel rows, with the launches of every
    main path's run summed."""
    from repro_torch.config import get_config, get_reduced_config
    from repro_torch.models.transformer import init_params

    t_mark = [time.perf_counter()]

    def mark(what):
        """Log the seconds since the last mark: where the run's time
        goes, for keeping it inside its budget."""
        now = time.perf_counter()
        log(f"time: {what} {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    errs = phase_kernels(torch, device)
    mark("kernels")
    times = phase_timing(torch, device, smi)
    mark("timing")
    launches = {name: 0 for name in REPLACES}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    add(phase_train(torch, device, smi))
    mark("train")
    add(phase_sim(torch, device, smi))
    mark("sim")

    full = get_config(FULL)
    params = init_params(full, seed=0, device=device)
    # one drain per layout (the k = 0 streams phase_spec and phase_swap
    # are held to); PRs 18-22 also ran a second pair in turns
    drained = {}
    for layout in ("paged", "dense"):
        got, res = phase_e2e(torch, device, full, params, smi, layout)
        add(got)
        drained[layout] = res["tokens"]
    mark("e2e")
    # 8 slots only (4 slots ran within its standard error of 8)
    phase_split_rule(torch, device, full, params, smi, 8)
    mark("split rule")
    add(phase_serve(torch, device, full, "paged"))
    # 32 slots (B.KV = 256 > the SM count): decode takes the one-split
    # kernel, the only engine here that does
    add(phase_serve(torch, device, full, "paged", max_slots=32))
    # 16 tokens a round (32 before, cut for time)
    add(phase_round(torch, device, full, params, smi, max_new=16)[0])
    mark("serve_continuous, round")
    add(phase_preempt(torch, device, full, params, smi, drained["paged"]))
    add(phase_http(torch, device, full, params, smi))
    add(phase_sampling(torch, device, full, params, smi))
    mark("preempt, http, sampling")
    add(phase_prefix(torch, device, full, params, smi))
    mark("prefix")
    add(phase_spec(torch, device, full, params, smi, drained)[0])
    mark("spec")
    add(phase_swap(torch, device, full, params, smi, drained["paged"]))
    mark("swap")
    del params
    torch.cuda.empty_cache()
    phase_serve_round(torch, device, full, smi)
    phase_parity(torch, device, get_reduced_config(FULL))
    mark("serve_round, parity")
    add(phase_pool(torch, device, smi))
    phase_pool_parity(torch, device, get_reduced_config(FULL))
    phase_prefix_parity(torch, device)
    mark("pool, pool parity, prefix parity")
    for arch in RECURRENT:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        log(f"{arch}: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} G "
            f"params initialised on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        # 8 requests and 8 tokens a round (16 and 32 before PR 24, 16
        # tokens before PR 25: cut for time)
        add(phase_e2e(torch, device, cfg, params, smi, "dense",
                      n_req=8)[0])
        add(phase_round(torch, device, cfg, params, smi, max_new=8)[0])
        del params
        torch.cuda.empty_cache()
        # 4 requests (8 before PR 25, cut for time)
        phase_parity(torch, device, get_reduced_config(arch),
                     ("dense", "paged"), n_req=4)
        mark(arch)
    add(phase_serve(torch, device, get_config(RECURRENT[-1]), "dense"))
    add(phase_moe(torch, device, smi))
    mark("moe")
    for arch in MOE:
        # 4 requests (8 before PR 25, cut for time)
        phase_parity(torch, device, get_reduced_config(arch), n_req=4)
    # the published capacity factor is 1.25; at 1.0 prefill chunks and
    # rounds drop entries on the card (8 requests, so they do)
    phase_parity(torch, device, dataclasses.replace(
        get_reduced_config(MOE[0]), capacity_factor=1.0), need_drops=True)
    mark("moe parity")
    add(phase_families(torch, device, smi))
    mark("families")
    for arch, _, _, layouts, _ in FAMILIES:
        # the decoder-only families on both layouts; seamless in round
        # mode, the only path the reference serves it on; 4 requests (8
        # before PR 25, cut for time)
        phase_parity(torch, device, get_reduced_config(arch),
                     ("paged", "dense") if layouts else (), n_req=4)
    mark("family parity")
    phase_frontend_parity(torch, device)
    mark("frontend parity")
    add(phase_edge(torch, device, smi))
    mark("edge nets")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"kernels never launched on a main path: {idle}")
    src = "src/repro_torch/kernels/csrc/{}.cu"
    return [{"name": n, "route": "cuda", "source": src.format(n),
             "replaces": REPLACES[n], "launches": launches[n],
             "max_abs_err": errs[n], **times[n]} for n in REPLACES]


def _leaves(tree):
    """The tensors of a nested dict/list of params."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke test runs "
              "on a GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    kernels = run(torch, device, smi)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
