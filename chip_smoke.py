#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the seven hand-written kernels (four attention kernels, the
RG-LRU and the RWKV-6 scans, the grouped expert GEMM) from the sources in
this checkout, holds each against its plain PyTorch version at the main
paths' shapes on poisoned inputs, times them, serves full-width
qwen3-0.6b through each main path (the paged continuous engine, round
mode with the SAC scheduler, the dense continuous engine), full-width
recurrentgemma-2b and rwkv6-3b through the dense continuous engine and
round mode, and arctic-480b at full width cut to one layer through the
paged continuous engine and round mode, with exact kernel launch counts,
and checks the card's greedy tokens against the CPU's on every path at
reduced width (the MoE family also with capacity drops).

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
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")




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
#: and eight prompts, a length off the 64-slot tile, a window, and a
#: non-causal case with T off the tile and T != S
FLASH_CASES = ((1, 16, 16, True, None), (1, 100, 100, True, None),
               (1, 512, 512, True, None), (8, 16, 16, True, None),
               (8, 100, 100, True, None), (8, 512, 512, True, None),
               (8, 512, 512, True, 64), (1, 40, 100, False, None))

#: the local layers of recurrentgemma-2b: 10 query heads over one KV head
#: of 256 (MQA), window 2048 (wider than any prompt bucket), and the
#: reduced config's 64-slot window
RG_HEADS = {"H": 10, "KV": 1, "hd": 256}
FLASH_RG_CASES = ((1, 100, 100, True, 2048), (8, 512, 512, True, 2048),
                  (2, 512, 512, True, 64))


def decode_case(torch, device, C, mode, B=8, H=16, KV=8, hd=128, seed=4,
                window=64, front=None):
    """q (B,1,H,hd) against a dense (B, C, KV, hd) cache. ``mode``:
    "linear" (ragged frontiers, full capacity included), "round" (every
    row at one frontier, ``front`` or C - 16, as a round's lock-step
    decode), or "ring" (the reference's ring mask with ``window``,
    wrapping ones included). Returns the kernel's case (invalid slots
    NaN) and the plain version's (the same cache with them zeroed)."""
    rng = np.random.default_rng(seed + C)
    slots = np.arange(C)[None, :]
    if mode == "linear":
        lens = np.array([1, 17, 100, 257, 333, 480, C - 1, C][:B])
        valid = slots < lens[:, None]
    elif mode == "round":
        valid = np.broadcast_to(slots < (front or C - 16), (B, C))
    else:
        pos = np.array([5, 63, 64, 300, C - 1, C, C + 60, 3 * C + 7][:B])
        k_pos = pos[:, None] - ((pos[:, None] - slots) % C)
        valid = (k_pos >= 0) & (k_pos > pos[:, None] - window)
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
#: the dense continuous engine's (max_seq 640), then a ring mask
DECODE_CASES = ((544, "round"), (544, "linear"), (640, "linear"),
                (640, "ring"))

#: (C, mode, extra): recurrentgemma-2b's local layers: a round's
#: 2048-slot ring filled to 528 (prompt bucket 512 + 16 tokens), the
#: dense engine's 640-slot rows, a 2048-slot ring wrapping with window
#: 2048, and the reduced config's 64-slot ring
DECODE_RG_CASES = ((2048, "round", {"front": 528}), (640, "linear", {}),
                   (2048, "ring", {"window": 2048}),
                   (64, "ring", {"window": 64}))

#: (B, S, W): rglru_scan at recurrentgemma-2b's width 2560, one and
#: eight 512-token sequences, and a ragged case off every tile
RGLRU_CASES = ((1, 512, 2560), (8, 512, 2560), (2, 33, 100))
#: (B, S, H, hd): rwkv6_scan at rwkv6-3b's 40 heads of 64, one and
#: eight 512-token sequences, and the largest head size (128)
RWKV_CASES = ((1, 512, 40, 64), (8, 512, 40, 64), (1, 64, 1, 128))


def rglru_case(torch, device, B, S, W, seed=5):
    """The distributions of tests/test_kernels.py: a in (0.4, 0.9),
    x and h0 normal; every input at the head of a NaN-tailed buffer."""
    rng = np.random.default_rng(seed + B * S + W)
    arrs = {"a": rng.random((B, S, W)) * 0.5 + 0.4,
            "x": rng.standard_normal((B, S, W)) * 0.3,
            "h0": rng.standard_normal((B, W)) * 0.1}
    return {n: _nan_headed(torch, a.astype(np.float32), device)
            for n, a in arrs.items()}


def rwkv_case(torch, device, B, S, H, hd, seed=6):
    """The distributions of tests/test_kernels.py: w in (0.4, 0.9), the
    rest normal; every input at the head of a NaN-tailed buffer."""
    rng = np.random.default_rng(seed + B * S + H * hd)
    seq = (B, S, H, hd)
    arrs = {"r": rng.standard_normal(seq),
            "k": rng.standard_normal(seq) * 0.3,
            "v": rng.standard_normal(seq) * 0.3,
            "w": rng.random(seq) * 0.5 + 0.4,
            "u": rng.standard_normal((H, hd)) * 0.1,
            "state": rng.standard_normal((B, H, hd, hd)) * 0.1}
    return {n: _nan_headed(torch, a.astype(np.float32), device)
            for n, a in arrs.items()}


#: (E, C, d, f): moe_matmul at the shapes of tests/test_kernels.py (C, d
#: and f off the kernel's 8/16-row, 64-deep and 512-column tiles)
MOE_REF_CASES = ((2, 32, 64, 48), (4, 40, 48, 56), (8, 16, 128, 128))
#: (E, C, d, f) at full-width arctic-480b (128 experts, d 7168, expert
#: width 4864): the capacity of a decode iteration over 8 slots (top-2,
#: 8.0 slots of 8), of a 512-token prefill chunk (16) and of a round's
#: one-shot prefill at b=8, S=512 (80), for w_gate/w_up; w_down swaps d
#: and f
MOE_ARCTIC = (128, 7168, 4864)
MOE_ARCTIC_CASES = ((128, 8, 7168, 4864), (128, 16, 7168, 4864),
                    (128, 8, 4864, 7168))
MOE_TIMING_CASES = ((128, 8, 7168, 4864), (128, 16, 7168, 4864),
                    (128, 80, 7168, 4864))


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


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def _check(torch, name, got, want, what):
    """Max abs error of every output of ``got`` against ``want``; fails
    on a non-finite output or an error above TOL."""
    err = 0.0
    for g, w in zip(_outputs(got), _outputs(want)):
        if not torch.isfinite(g).all():
            fail(f"{name} {what}: non-finite output (poison read)")
        err = max(err, float((g - w).abs().max()))
    log(f"{name} {what}: max abs err vs plain {err:.3e} (tolerance {TOL:g})")
    if not err <= TOL:
        fail(f"{name} {what} disagrees with its plain version: {err:.3e} > "
             f"{TOL:g}")
    return err


def phase_kernels(torch, device):
    """Every kernel vs its plain version at the main paths' shapes, on
    poisoned inputs. Returns name -> worst max abs error."""
    w = _wrappers()
    errs = {name: 0.0 for name in w}

    def run(name, what, kern_args, plain_args=None):
        kern, plain = w[name]
        got = kern(**kern_args)
        want = plain(**(plain_args or kern_args))
        errs[name] = max(errs[name], _check(torch, name, got, want, what))

    c = paged_decode_case(torch, device)
    run("paged_decode_attention", f"q {tuple(c['q'].shape)} pools "
        f"{tuple(c['k_pool'].shape)} seq_lens {c['seq_lens'].tolist()}", c)
    for T, pos in PREFILL_CASES:
        run("paged_prefill_attention", f"q (1,{T},16,128) pos {pos}",
            paged_prefill_case(torch, device, T, pos))
    for B, S, T, causal, window in FLASH_CASES:
        c = flash_case(torch, device, B, S, T, causal, window)
        run("flash_attention", f"B={B} S={S} T={T} causal={causal} "
            f"window={window}", c)
    for C, mode in DECODE_CASES:
        kc, pc = decode_case(torch, device, C, mode)
        run("decode_attention", f"q (8,1,16,128) C={C} {mode}, "
            f"{int(kc['valid'].sum())} valid slots", kc, pc)
    for B, S, T, causal, window in FLASH_RG_CASES:
        c = flash_case(torch, device, B, S, T, causal, window, **RG_HEADS)
        run("flash_attention", f"H=10 KV=1 hd=256 B={B} S={S} T={T} "
            f"window={window}", c)
    for C, mode, extra in DECODE_RG_CASES:
        kc, pc = decode_case(torch, device, C, mode, **RG_HEADS, **extra)
        run("decode_attention", f"q (8,1,10,256) C={C} {mode} {extra}, "
            f"{int(kc['valid'].sum())} valid slots", kc, pc)
    for B, S, W in RGLRU_CASES:
        run("rglru_scan", f"(B,S,W)=({B},{S},{W}), NaN-tailed inputs",
            rglru_case(torch, device, B, S, W))
    for B, S, H, hd in RWKV_CASES:
        run("rwkv6_scan", f"(B,S,H,hd)=({B},{S},{H},{hd}), NaN-tailed "
            "inputs", rwkv_case(torch, device, B, S, H, hd))
    for E, C, D, F in MOE_REF_CASES + MOE_ARCTIC_CASES:
        c = moe_case(torch, device, E, C, D, F)
        run("moe_matmul", f"x ({E},{C},{D}) @ w ({E},{D},{F}), NaN-tailed "
            "inputs", c)
        del c
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 4
def _time_ms(torch, fn, n_args, iters=50):
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
        f"q {tuple(c0['q'].shape)}"


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
    n_bytes = 4 * (3 * B * S * W + 2 * B * W)
    copies = [rglru_case(torch, device, B, S, W, seed=40 + i)
              for i in range(_copies(n_bytes))]
    return copies, copies, None, _bound(n_bytes, 2 * B * S * W), \
        f"(B,S,W)=({B},{S},{W})"


def _rwkv_job(torch, device, B, S, H, hd):
    """No single PyTorch call computes the recurrence (library none); the
    bound counts r, k, v, w, u and the state read once, the output and
    the final state written once, and 5 * hd^2 + 5 * hd flops per (b, t,
    head): r . S over the keys (2 hd^2), the decay and the k v^T update
    (3 hd^2), and the bonus, which factors as v_j * sum_i r_i u_i k_i
    (5 hd)."""
    n_bytes = 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    copies = [rwkv_case(torch, device, B, S, H, hd, seed=50 + i)
              for i in range(_copies(n_bytes))]
    return copies, copies, None, _bound(n_bytes, B * S * H * (5 * hd * hd + 5 * hd)), \
        f"(B,S,H,hd)=({B},{S},{H},{hd})"


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


def phase_timing(torch, device, smi):
    """CUDA-event times of kernel, plain version and the library call, in
    the order plain, kernel, kernel, plain (library at both ends). The
    first shape of each kernel is its row in the result line."""
    w = _wrappers()
    jobs = [("paged_decode_attention", lambda: _paged_job(
        torch, device, paged_decode_case, {}))]
    jobs += [("paged_prefill_attention", lambda T=T, pos=pos: _paged_job(
        torch, device, paged_prefill_case, {"T": T, "pos": pos}))
        for T, pos in ((512, 0), (128, 200), (16, 8))]
    jobs += [("flash_attention", lambda a=a: _flash_job(torch, device, *a))
             for a in ((8, 512, 512, True, None), (1, 100, 100, True, None),
                       (8, 512, 512, True, 64))]
    jobs += [("decode_attention", lambda a=a: _decode_job(torch, device, *a))
             for a in ((544, "round"), (640, "linear"), (640, "ring"))]
    jobs += [("flash_attention", lambda a=a: _flash_job(
        torch, device, *a, **RG_HEADS)) for a in FLASH_RG_CASES[1:]]
    jobs += [("decode_attention", lambda c=c, m=m, x=x: _decode_job(
        torch, device, c, m, **RG_HEADS, **x))
        for c, m, x in DECODE_RG_CASES[:3]]
    jobs += [("rglru_scan", lambda a=a: _rglru_job(torch, device, *a))
             for a in RGLRU_CASES[:2]]
    jobs += [("rwkv6_scan", lambda a=a: _rwkv_job(torch, device, *a))
             for a in RWKV_CASES[:2]]
    jobs += [("moe_matmul", lambda a=a: _moe_job(torch, device, *a))
             for a in MOE_TIMING_CASES]
    out = {}
    for name, make in jobs:
        kern, plain = w[name]
        k_args, p_args, lib, (bound, by), what = make()
        n = len(k_args)
        t = {"lib": [], "plain": [], "kern": []}
        if lib:
            t["lib"].append(_time_ms(torch, lib, n))
        t["plain"].append(_time_ms(torch, lambda i: plain(**p_args[i]), n))
        t["kern"].append(_time_ms(torch, lambda i: kern(**k_args[i]), n))
        t["kern"].append(_time_ms(torch, lambda i: kern(**k_args[i]), n))
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
        log(f"timing {name} {what}: kernel_ms {row['ms']:.4f} (runs "
            f"{t['kern']}), plain_ms {row['plain_ms']:.4f}, library_ms "
            f"{lib_note}, bound_ms {bound:.4f} by {by}, "
            f"{bound / row['ms']:.1%} of bound [{smi}]")
        out.setdefault(name, row)
        del k_args, p_args, lib
        torch.cuda.empty_cache()
    return out


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


def _want(cfg, path, n_iters=0, n_chunks=0, n_rounds=0, n_tokens=0):
    """The exact kernel launches of one serving path: per attention layer
    (``attn``/``attn_dense``/``local_attn``) one decode kernel per decode
    iteration or round token and, paged, one chunk kernel per prefill
    chunk (dense chunks attend in plain PyTorch), or one flash launch per
    round; per recurrent layer one scan per prefill chunk or round (decode
    steps are the one-step formula); per MoE layer three grouped GEMMs
    (gate, up, down) per forward: every decode iteration, chunk, round and
    round token."""
    kinds = cfg.layer_kinds()
    A = sum(k in ("attn", "attn_dense", "local_attn") for k in kinds)
    M = sum(k != "attn_dense" for k in kinds) if cfg.n_experts else 0
    want = {name: 0 for name in REPLACES}
    if path in ("paged", "dense"):
        want["moe_matmul"] = 3 * M * (n_iters + n_chunks)
    else:
        want["moe_matmul"] = 3 * M * (n_rounds + n_tokens)
    if path == "paged":
        want["paged_decode_attention"] = A * n_iters
        want["paged_prefill_attention"] = A * n_chunks
        return want
    if path == "dense":
        want["decode_attention"] = A * n_iters
        seqs = n_chunks
    else:  # round
        want["flash_attention"] = A * n_rounds
        want["decode_attention"] = A * n_tokens
        seqs = n_rounds
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
    res = {"tokens_per_s": gen / wall,
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


def _profiled(torch, fn):
    """Run ``fn`` under torch.profiler; returns (wall s, device busy ms,
    device kernels launched, {kernel name: device ms})."""
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


def phase_profile(torch, eng, rng, decode_p50_ms, smi, label):
    """Where an iteration's time goes: one prefill-heavy step (8 prompts
    of 30..400 tokens admitted at once under the 512-token budget) and
    three decode-only steps, each under torch.profiler. Device busy time
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
    _report_profile(report, smi, label)
    busy = report[1][3] / 3
    log(f"profile {label}: decode-only device busy {busy:.3f} ms of the "
        f"unprofiled p50 {decode_p50_ms:.3f} ms per iteration: idle share "
        f"{1 - busy / decode_p50_ms:.1%}")


def phase_serve(torch, device, cfg, kv_layout):
    """The normal entry point, serve_continuous, at full width."""
    from repro_torch.launch.engine_serve import serve_continuous

    reset_launches()
    stats = serve_continuous(cfg=cfg, kv_layout=kv_layout, duration_s=5.0,
                             device=device)
    got = read_launches()
    want = _want(cfg, kv_layout, n_iters=int(stats["n_iters"]),
                 n_chunks=int(stats["n_prefill_chunks"]))
    if stats["served"] < 1 or got != want:
        fail(f"serve_continuous {cfg.name} {kv_layout}: served "
             f"{stats['served']}, launches {got} != {want}")
    log(f"serve_continuous {cfg.name} {kv_layout}: {stats['served']:.0f} "
        f"requests in 5 s, launches {got} == {want}")
    torch.cuda.empty_cache()


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
    # 20 s (the reference's default) hold enough rounds for the agent's
    # 32-round mini-batch
    stats = serve_round(cfg=cfg, duration_s=20.0, device=device)
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
    """|logit[a] - logit[b]| of the CPU model after the token sequence
    ``seq`` (padded prompt and emitted tokens), in one prefill."""
    from repro_torch.models import build_model

    logits, _ = build_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(np.asarray(seq, np.int32)[None])})
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


def run(torch, device, smi):
    """Every phase after the build: kernels vs plain, timing, the three
    serving paths of full-width qwen3-0.6b, then the dense continuous
    engine and round mode of each full-width recurrent family and the
    paged engine and round mode of arctic-480b cut to one layer (one
    model on the card at a time), and card-vs-CPU parity at reduced
    width.
    Returns the result line's kernel rows, with the launches of every
    main path's run summed."""
    from repro_torch.config import get_config, get_reduced_config
    from repro_torch.models.transformer import init_params

    errs = phase_kernels(torch, device)
    times = phase_timing(torch, device, smi)
    launches = {name: 0 for name in REPLACES}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    full = get_config(FULL)
    params = init_params(full, seed=0, device=device)
    # the two layouts' drains in turns (paged, dense, dense, paged): host
    # time on a shared machine drifts, so only alternated runs compare
    runs = {"paged": [], "dense": []}
    for i, layout in enumerate(("paged", "dense", "dense", "paged")):
        got, res = phase_e2e(torch, device, full, params, smi, layout,
                             profile=i < 2)
        if i < 2:
            add(got)
        runs[layout].append(res)
    for key, what in (("tokens_per_s", "generated tokens/s"),
                      ("p50", "decode iteration p50 ms"),
                      ("p99", "decode iteration p99 ms")):
        log(f"e2e paged vs dense, {what}: {[r[key] for r in runs['paged']]}"
            f" vs {[r[key] for r in runs['dense']]} [{smi}]")
    phase_serve(torch, device, full, "paged")
    add(phase_round(torch, device, full, params, smi)[0])
    del params
    torch.cuda.empty_cache()
    phase_serve_round(torch, device, full, smi)
    phase_parity(torch, device, get_reduced_config(FULL))
    for arch in RECURRENT:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        log(f"{arch}: {sum(t.numel() for t in _leaves(params)) / 1e9:.2f} G "
            f"params initialised on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        add(phase_e2e(torch, device, cfg, params, smi, "dense")[0])
        add(phase_round(torch, device, cfg, params, smi)[0])
        del params
        torch.cuda.empty_cache()
        phase_parity(torch, device, get_reduced_config(arch), ("dense",))
    phase_serve(torch, device, get_config(RECURRENT[-1]), "dense")
    add(phase_moe(torch, device, smi))
    for arch in MOE:
        phase_parity(torch, device, get_reduced_config(arch))
    # the published capacity factor is 1.25; at 1.0 prefill chunks and
    # rounds drop entries on the card
    phase_parity(torch, device, dataclasses.replace(
        get_reduced_config(MOE[0]), capacity_factor=1.0), need_drops=True)
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
