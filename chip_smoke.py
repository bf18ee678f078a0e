#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels from the sources in this checkout,
holds each against its plain PyTorch version at the main path's shapes,
times them, serves full-width qwen3-0.6b through the paged
continuous-batching engine, and checks the card's greedy tokens against
the CPU's.

    python3 chip_smoke.py

Run from the root of a checkout. Exits non-zero, printing no result,
without a CUDA device or without the checkout's ``src/repro_torch``.
Every phase that fails raises; the last line of standard output is
``{"ok": true, "device": {...}}`` only when all of them passed. Imports
nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

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
#: layers whose every decode iteration / prefill chunk launches a kernel
FULL = "qwen3-0.6b"


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
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel)")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
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


def decode_case(torch, device, B=8, H=16, KV=8, hd=128, bs=16, nb=40,
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


def prefill_case(torch, device, T, pos, H=16, KV=8, hd=128, bs=16, nb=40,
                 seed=2):
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


#: (T, pos): one row at the last slot, chunks starting mid-block, a full
#: 512-token first chunk and one that ends at the full 640 capacity
PREFILL_CASES = ((1, 639), (16, 8), (128, 200), (512, 0), (512, 128))


def phase_kernels(torch, device):
    """Kernel vs plain version at the main path's shapes, on poisoned
    inputs. Returns name -> max abs error."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import prefill_attention as pre

    errs = {}
    c = decode_case(torch, device)
    got = dec.paged_decode_attention(**c)
    want = dec.paged_decode_attention_plain(**c)
    if not torch.isfinite(got).all():
        fail("paged_decode_attention: non-finite output (poison read)")
    errs["paged_decode_attention"] = float((got - want).abs().max())
    log(f"paged_decode_attention q {tuple(c['q'].shape)} pools "
        f"{tuple(c['k_pool'].shape)} tables "
        f"{tuple(c['block_tables'].shape)} seq_lens "
        f"{c['seq_lens'].tolist()}: max abs err vs plain "
        f"{errs['paged_decode_attention']:.3e} (tolerance {TOL:g})")
    worst = 0.0
    for T, pos in PREFILL_CASES:
        c = prefill_case(torch, device, T, pos)
        got = pre.paged_prefill_attention(**c)
        want = pre.paged_prefill_attention_plain(**c)
        if not torch.isfinite(got).all():
            fail(f"paged_prefill_attention T={T} pos={pos}: non-finite "
                 "output (poison read)")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"paged_prefill_attention q {tuple(c['q'].shape)} pos {pos}: "
            f"max abs err vs plain {err:.3e} (tolerance {TOL:g})")
    errs["paged_prefill_attention"] = worst
    for name, err in errs.items():
        if not err <= TOL:
            fail(f"{name} disagrees with its plain version: {err:.3e} > "
                 f"{TOL:g}")
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


def _gathered(torch, c, last):
    """The logical K/V view (B, KV, S, hd) and a bool mask (B, 1, T, S)
    from query row limits ``last`` (B, T): the library yardstick's
    inputs, built outside its timing."""
    B, nb = c["block_tables"].shape
    N, bs, KV, hd = c["k_pool"].shape
    tbl = c["block_tables"].long()
    live = (torch.arange(nb, device=tbl.device)[None] * bs
            <= last[:, -1:]) & (tbl >= 0) & (tbl < N)
    tbl = torch.where(live, tbl, 0)
    k = c["k_pool"][tbl].reshape(B, nb * bs, KV, hd)
    v = c["v_pool"][tbl].reshape(B, nb * bs, KV, hd)
    slot = torch.arange(nb * bs, device=tbl.device)
    mask = slot[None, None, :] <= last[:, :, None]
    v = torch.where(mask.any(1)[:, :, None, None], v, 0.0)
    k = torch.where(mask.any(1)[:, :, None, None], k, 0.0)
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            mask[:, None])


def _sdpa(torch, q, k, v, mask, scale):
    """scaled_dot_product_attention over the gathered view (GQA)."""
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


def _bound(case, last, H, hd, KV):
    """Least time for the function on the card: each input byte it needs
    read once (q, the live K/V slots, live table entries), the output
    written once, against the flops of the two products over the slots
    each query row attends. Returns (ms, "bytes" | "operations")."""
    attended = (last + 1).clamp(min=0)                  # (B, T)
    per_seq = attended.max(1).values                    # K/V slots read
    bs = case["k_pool"].shape[1]
    n_bytes = (2 * case["q"].numel() * 4
               + int(per_seq.sum()) * KV * hd * 4 * 2
               + 4 * int((-(-per_seq // bs)).sum()) + 4 * last.shape[0])
    flops = 4 * H * hd * int(attended.sum())
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing(torch, device, smi):
    """CUDA-event times of kernel, plain version and the library call, in
    the order plain, kernel, kernel, plain (library at both ends)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import prefill_attention as pre

    out = {}
    jobs = [("paged_decode_attention", dec.paged_decode_attention,
             dec.paged_decode_attention_plain, decode_case, {})]
    jobs += [("paged_prefill_attention", pre.paged_prefill_attention,
              pre.paged_prefill_attention_plain, prefill_case,
              {"T": T, "pos": pos}) for T, pos in ((16, 8), (128, 200),
                                                   (512, 0))]
    for name, kern, plain, make, kw in jobs:
        copies = [make(torch, device, seed=10 + i, **kw) for i in range(4)]
        c0 = copies[0]
        B, T, H, hd = c0["q"].shape
        KV = c0["k_pool"].shape[2]
        args = copies
        if "seq_lens" in c0:
            last = [(c["seq_lens"].long() - 1)[:, None] for c in copies]
        else:
            last = [c["pos"].long()[:, None]
                    + torch.arange(T, device=device)[None] for c in copies]
        lib_in = [_gathered(torch, c, lst) for c, lst in zip(copies, last)]

        def run_lib(i):
            k, v, mask = lib_in[i]
            return _sdpa(torch, copies[i]["q"], k, v, mask, c0["scale"])

        t = {"lib": [], "plain": [], "kern": []}
        t["lib"].append(_time_ms(torch, run_lib, 4))
        t["plain"].append(_time_ms(torch, lambda i: plain(**args[i]), 4))
        t["kern"].append(_time_ms(torch, lambda i: kern(**args[i]), 4))
        t["kern"].append(_time_ms(torch, lambda i: kern(**args[i]), 4))
        t["plain"].append(_time_ms(torch, lambda i: plain(**args[i]), 4))
        t["lib"].append(_time_ms(torch, run_lib, 4))
        lib_out = run_lib(0).transpose(1, 2)
        lib_err = float((lib_out - plain(**args[0])).abs().max())
        bound, by = _bound(c0, last[0], H, hd, KV)
        row = {"ms": float(np.mean(t["kern"])),
               "plain_ms": float(np.mean(t["plain"])),
               "library_ms": float(np.mean(t["lib"])),
               "bound_ms": bound, "bound_by": by}
        log(f"timing {name} q {tuple(c0['q'].shape)}: kernel_ms "
            f"{row['ms']:.4f} (runs {t['kern']}), plain_ms "
            f"{row['plain_ms']:.4f}, library_ms {row['library_ms']:.4f} "
            f"(sdpa vs plain max err {lib_err:.2e}), bound_ms "
            f"{bound:.4f} by {by}, {row['bound_ms'] / row['ms']:.1%} of "
            f"bound [{smi}]")
        if T in (1, 512):  # decode; the largest prefill chunk
            out[name] = row
    return out


# ---------------------------------------------------------------- phase 5
def _watch_logits(torch, model, bad):
    """Wrap the model's forwards so each output's finiteness is recorded
    (as device booleans, read once at the end)."""
    for attr in ("decode_step", "prefill_chunk"):
        orig = getattr(model, attr)

        def checked(params, cache, batch, _orig=orig):
            logits, cache = _orig(params, cache, batch)
            bad.append(~torch.isfinite(logits).all())
            return logits, cache
        setattr(model, attr, checked)


def phase_e2e(torch, device, cfg, smi, n_req=16, max_new=32, seed=0):
    """Serve ``n_req`` seeded requests (prompts 4..500 tokens) through the
    paged engine at full width until drained; check every request and
    the launch counts. Returns the kernels' main-path launch counts."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import prefill_attention as pre
    from repro_torch.serving.engine import ContinuousBatchingEngine

    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                   kv_layout="paged", token_budget=512,
                                   device=device, seed=seed)
    torch.cuda.synchronize()
    log(f"e2e: {cfg.name} L={cfg.n_layers} d={cfg.d_model} engine built in "
        f"{time.perf_counter() - t0:.1f} s, pool "
        f"{tuple(eng.cache[0]['k'].shape)} x {len(eng.cache)} layers x k,v")
    rng = np.random.default_rng(seed)
    eng.run([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
            max_new_tokens=2)  # warm-up: cuBLAS handles, kernel libraries
    lens = rng.permutation(np.linspace(4, 500, n_req).round().astype(int))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    bad = []
    _watch_logits(torch, eng.model, bad)
    it0, ch0, tok0 = eng.n_iters, eng.n_prefill_chunks, \
        eng.n_prefill_chunk_tokens
    torch.cuda.reset_peak_memory_stats()
    dec.paged_decode_attention.launches = 0
    pre.paged_prefill_attention.launches = 0
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
    launches = {"paged_decode_attention": dec.paged_decode_attention.launches,
                "paged_prefill_attention":
                    pre.paged_prefill_attention.launches}
    n_iters, n_chunks = eng.n_iters - it0, eng.n_prefill_chunks - ch0
    n_pre = eng.n_prefill_chunk_tokens - tok0
    if len(results) != n_req or any(len(r.tokens) != max_new
                                    for r in results):
        fail(f"e2e: {len(results)} of {n_req} requests finished, token "
             f"counts {[len(r.tokens) for r in results]}")
    if bool(torch.stack(bad).any()):
        fail("e2e: non-finite logits")
    L = cfg.n_layers
    if launches["paged_decode_attention"] != L * n_iters or \
            launches["paged_prefill_attention"] != L * n_chunks:
        fail(f"e2e: launches {launches} != {L} x ({n_iters} decode "
             f"iterations, {n_chunks} prefill chunks)")
    gen = sum(len(r.tokens) for r in results)
    log(f"e2e: {n_req} requests (prompts {int(lens.min())}..{int(lens.max())}"
        f" tokens), {gen} generated tokens, {n_iters} decode iterations, "
        f"{n_chunks} prefill chunks ({n_pre} tokens), wall {wall:.3f} s, "
        f"{gen / wall:.1f} generated tokens/s, decode-only iteration ms p50 "
        f"{np.percentile(decode_ms, 50):.3f} p99 "
        f"{np.percentile(decode_ms, 99):.3f} (n={len(decode_ms)}), "
        f"prefill {n_pre / max(prefill_s, 1e-9):.0f} tokens/s over steps "
        f"with prefill ({prefill_s:.3f} s, their decode included), peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")
    log(f"e2e: launches {launches} == {L} x ({n_iters} iterations, "
        f"{n_chunks} chunks)")
    phase_profile(torch, eng, rng, float(np.percentile(decode_ms, 50)), smi)
    del eng
    torch.cuda.empty_cache()
    return launches


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


def phase_profile(torch, eng, rng, decode_p50_ms, smi):
    """Where an iteration's time goes: one prefill-heavy step (8 prompts
    of 30..400 tokens admitted at once under the 512-token budget) and
    three decode-only steps, each under torch.profiler. Device busy time
    is the sum of kernel durations; the decode steps' busy share is taken
    against the unprofiled decode p50 of phase 5 (the profiler slows the
    host)."""
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
    if not all(r[3] > 0 for r in report):
        fail("profile: torch.profiler recorded no device time")
    for label, steps, wall, busy, n, names in report:
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        log(f"profile {label}: device busy {busy / steps:.3f} ms/step, "
            f"{n // steps} kernels/step, profiled wall "
            f"{wall * 1e3 / steps:.3f} ms/step [{smi}]")
        for name, ms in top:
            log(f"  {ms / steps:8.3f} ms/step {ms / busy:6.1%}  {name[:90]}")
    busy = report[1][3] / 3
    log(f"profile: decode-only device busy {busy:.3f} ms of the unprofiled "
        f"p50 {decode_p50_ms:.3f} ms per iteration: idle share "
        f"{1 - busy / decode_p50_ms:.1%}")


def phase_serve(torch, device, cfg):
    """The normal entry point, serve_continuous, at full width."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import prefill_attention as pre
    from repro_torch.launch.engine_serve import serve_continuous

    dec.paged_decode_attention.launches = 0
    pre.paged_prefill_attention.launches = 0
    stats = serve_continuous(cfg=cfg, kv_layout="paged", duration_s=5.0,
                             device=device)
    L = cfg.n_layers
    if stats["served"] < 1 or \
            dec.paged_decode_attention.launches != L * stats["n_iters"] or \
            pre.paged_prefill_attention.launches != \
            L * stats["n_prefill_chunks"]:
        fail(f"serve_continuous: served {stats['served']}, launches "
             f"{dec.paged_decode_attention.launches}/"
             f"{pre.paged_prefill_attention.launches} vs stats {stats}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 6
def _margin(torch, cfg, params, prompt, tokens, a, b):
    """|logit[a] - logit[b]| of the CPU model after ``prompt`` (padded as
    the engine pads it) and ``tokens``, in one prefill chunk."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SEQ_BUCKETS, _bucket

    S = _bucket(len(prompt), buckets=SEQ_BUCKETS)
    seq = np.concatenate([np.zeros(S - len(prompt), np.int32), prompt,
                          np.asarray(tokens, np.int32)])
    bs = 16
    nb = -(-len(seq) // bs)
    model = build_model(cfg)
    cache = model.init_paged_cache(1, len(seq), nb + 1, bs, device="cpu")
    batch = {"tokens": torch.from_numpy(seq[None]),
             "pos": torch.zeros(1, dtype=torch.int32),
             "block_tables": torch.arange(1, nb + 1,
                                          dtype=torch.int32)[None]}
    logits, _ = model.prefill_chunk(params, cache, batch)
    return float((logits[0, -1, a] - logits[0, -1, b]).abs())


def phase_parity(torch, device, cfg, n_req=8, max_new=16, seed=0):
    """Same weights, same requests: the engine on the card (kernels) and on
    the CPU (plain versions) must emit identical greedy tokens; a
    divergence counts as a tie only below a logit margin of 1e-5."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ContinuousBatchingEngine

    params = init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(3, 100, n_req).round().astype(int)]
    runs = {}
    for dev in (device, torch.device("cpu")):
        eng = ContinuousBatchingEngine(cfg, max_slots=4, max_seq=192,
                                       token_budget=64, device=dev,
                                       params=params)
        runs[dev.type] = eng.run(prompts, max_new_tokens=max_new)
    n_tok = 0
    for p, g, c in zip(prompts, runs[device.type], runs["cpu"]):
        n_tok += len(c.tokens)
        if np.array_equal(g.tokens, c.tokens):
            continue
        k = int(np.argmax(g.tokens != c.tokens))
        m = _margin(torch, cfg, params, p, c.tokens[:k], int(c.tokens[k]),
                    int(g.tokens[k]))
        log(f"parity: request {c.request_id} diverges at token {k} "
            f"(cpu {c.tokens[k]}, card {g.tokens[k]}), logit margin {m:.3e}")
        if not m < 1e-5:
            fail(f"parity: card and CPU tokens differ beyond a tie "
                 f"(margin {m:.3e})")
    log(f"parity: {cfg.name} reduced (L={cfg.n_layers}, d={cfg.d_model}, "
        f"H={cfg.n_heads}, KV={cfg.n_kv_heads}): {n_req} requests, {n_tok} "
        f"greedy tokens identical on card and CPU")


# ---------------------------------------------------------------- main
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
    from repro_torch.config import get_config, get_reduced_config

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    errs = phase_kernels(torch, device)
    times = phase_timing(torch, device, smi)
    launches = phase_e2e(torch, device, get_config(FULL), smi)
    phase_serve(torch, device, get_config(FULL))
    phase_parity(torch, device, get_reduced_config(FULL))
    src = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {"paged_decode_attention":
                "src/repro/kernels/decode_attention.py:164",
                "paged_prefill_attention":
                "src/repro/kernels/prefill_attention.py:85"}
    kernels = [{"name": n, "route": "cuda", "source": src.format(n),
                "replaces": replaces[n], "launches": launches[n],
                "max_abs_err": errs[n], **times[n]} for n in replaces]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
