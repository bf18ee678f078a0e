"""Beyond-paper figure: chunked prefill + SLO-aware preemption on the
real continuous engine.

Two panels on the mixed workload BCEdge's SLO story lives or dies on:
long prompts sharing an engine with short-SLO short requests.

1. **Iteration-latency bound**: one engine, short decode-heavy
   residents plus periodic long-prompt arrivals. Uncapped admission
   processes a whole 500-token prompt inside one iteration, so resident
   decodes stall for the full prefill (the p99 iteration spike). With a
   per-iteration token budget the same prompt lands as bounded chunks
   interleaved with decodes: p99 iteration time stays within ~2x the
   pure-decode iteration (the acceptance bound this module asserts).

2. **SLO attainment under preemption**: a pool whose slots are held by
   long, lazy-SLO hogs while tight-SLO requests arrive. Without
   preemption the urgent class waits out whole hog residencies and
   violates; with the EDF policy (largest-slack victim, hysteresis) it
   preempts into the freed slot and meets its deadline, while every
   preempted hog resumes to a token-identical completion (asserted
   against an uninterrupted reference run).

The engines run on ``device`` (dense layout: dense decode on the GPU).

Artifacts: ``experiments/figures_torch/fig_preemption_chunked.json``
(always) and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_preemption_chunked
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

TINY = ModelConfig(name="tiny-preempt", family="dense", n_layers=4,
                   d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                   vocab_size=211)

# panel 1: engine iteration-latency bound
CACHE_LEN = 768
N_SLOTS = 4
LONG_PROMPT = 500          # bucket 512: the prefill spike
SHORT_PROMPT = 8
TOKEN_BUDGET = 32
LONG_EVERY = 30            # steps between long-prompt arrivals

# panel 2: pool preemption SLO attainment
POOL_CACHE_LEN = 512
URGENT_SLO_MS = 400.0
URGENT_EVERY_S = 0.12


def _run_engine_panel(token_budget, n_steps: int, device="cuda",
                      trace: Optional[list] = None) -> dict:
    """Mixed long-prompt/short-decode traffic on one engine; returns the
    per-iteration latency distribution split into pure-decode and
    prefill-carrying steps (steps that built a kernel excluded). With
    ``trace`` a list, every step also appends (step, has_prefill, prefill
    chunks, whether a prompt landed, host ms, ms until the device
    finishes), the device synchronised after each step so that it cannot
    run ahead."""
    eng = ContinuousBatchingEngine(TINY, max_slots=N_SLOTS,
                                   max_seq=CACHE_LEN,
                                   token_budget=token_budget, device=device)
    rng = np.random.default_rng(0)
    short = lambda: rng.integers(  # noqa: E731
        1, TINY.vocab_size, SHORT_PROMPT).astype(np.int32)
    long_p = lambda: rng.integers(  # noqa: E731
        1, TINY.vocab_size, LONG_PROMPT).astype(np.int32)
    # warm every shape this run will touch (building kernels is not the
    # phenomenon being measured)
    eng.submit(long_p(), max_new_tokens=2)
    eng.submit(short(), max_new_tokens=2)
    while eng.active_slots or eng.waiting:
        eng.step()

    for _ in range(N_SLOTS - 1):
        eng.submit(short(), max_new_tokens=1000)  # long-lived residents
    decode_ms, prefill_ms = [], []
    for step in range(n_steps):
        if step % LONG_EVERY == 5:
            eng.submit(long_p(), max_new_tokens=4)
        has_prefill = eng.prefill_backlog_tokens > 0
        chunks, prefilling = eng.n_prefill_chunks, len(eng.prefilling_slots)
        t0 = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t0) * 1000.0
        if trace is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            trace.append((step, has_prefill, eng.n_prefill_chunks - chunks,
                          len(eng.prefilling_slots) < prefilling, ms,
                          (time.perf_counter() - t0) * 1000.0))
        if eng.last_step_compiled:
            continue
        (prefill_ms if has_prefill else decode_ms).append(ms)
    check(bool(decode_ms and prefill_ms), "workload never mixed the phases")
    all_ms = decode_ms + prefill_ms
    return {
        "token_budget": token_budget or 0,
        "decode_p50_ms": float(np.percentile(decode_ms, 50)),
        # host-noise spikes land in BOTH classes, so the headline bound
        # compares p99 against the pure-decode p99
        "decode_p99_ms": float(np.percentile(decode_ms, 99)),
        "p99_ms": float(np.percentile(all_ms, 99)),
        "max_ms": float(np.max(all_ms)),
        "prefill_steps": len(prefill_ms),
        "n_steps": len(all_ms),
    }


def _run_pool_panel(preemption: bool, hog_tokens: int, n_urgent: int,
                    device="cuda") -> dict:
    """Tight-SLO arrivals against slots held by lazy-SLO hogs; returns
    SLO attainment per class and the preempt-resume identity check."""
    pool = ModelInstancePool({TINY.name: TINY}, max_instances=1,
                             max_slots=2, max_seq=POOL_CACHE_LEN, seed=0,
                             preemption=preemption, max_preemptions=100,
                             preempt_cooldown_steps=4, device=device)
    pool.scale_to(TINY.name, 1)
    pool.warmup(seed=0)
    rng = np.random.default_rng(1)
    # calibrate the contention fit (the preemption trigger needs it)
    for _ in range(2):
        pool.submit(TINY.name, rng.integers(1, TINY.vocab_size, 8).astype(
            np.int32), slo_ms=60_000.0, max_new_tokens=8)
    pool.run_until_drained()

    hog_prompt = rng.integers(1, TINY.vocab_size, 20).astype(np.int32)
    ref = ContinuousBatchingEngine(
        TINY, max_slots=2, max_seq=POOL_CACHE_LEN, seed=0,
        device=device).run([hog_prompt], max_new_tokens=hog_tokens)[0].tokens

    hogs = [pool.submit(TINY.name, hog_prompt, slo_ms=600_000.0,
                        max_new_tokens=hog_tokens) for _ in range(2)]
    urgent_ids = []
    next_urgent = URGENT_EVERY_S
    t0 = pool.now()
    done = []
    for _ in range(50_000):
        if len(urgent_ids) < n_urgent and pool.now() - t0 >= next_urgent:
            urgent_ids.append(pool.submit(
                TINY.name,
                rng.integers(1, TINY.vocab_size, 8).astype(np.int32),
                slo_ms=URGENT_SLO_MS, max_new_tokens=2))
            next_urgent += URGENT_EVERY_S
        done.extend(pool.step())
        if len(done) == len(hogs) + n_urgent and len(urgent_ids) == n_urgent:
            break
    by_id = {r.request_id: r for r in done}
    urgent = [by_id[i] for i in urgent_ids]
    hog_res = [by_id[i] for i in hogs]
    identical = all(np.array_equal(r.tokens, ref) for r in hog_res)
    return {
        "preemption": preemption,
        "n_preempted": pool.n_preempted,
        "urgent_slo_attainment": float(np.mean(
            [not r.violated for r in urgent])),
        "urgent_p99_ms": float(np.percentile(
            [r.latency_ms for r in urgent], 99)),
        "hog_tokens_ok": all(len(r.tokens) == hog_tokens for r in hog_res),
        "hog_token_identical": bool(identical),
    }


def _plot(eng_rows: list, pool_rows: list, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    labels = ["uncapped", f"budget={TOKEN_BUDGET}"]
    x = np.arange(len(eng_rows))
    axes[0].bar(x - 0.2, [r["decode_p99_ms"] for r in eng_rows], 0.4,
                label="pure-decode p99", color="#888")
    axes[0].bar(x + 0.2, [r["p99_ms"] for r in eng_rows], 0.4,
                label="all-iterations p99", color="#c33")
    axes[0].set_xticks(x, labels)
    axes[0].set_ylabel("iteration ms")
    axes[0].set_title("chunked prefill bounds iteration latency")
    axes[0].legend(fontsize=7)
    labels2 = ["no preemption", "preemption"]
    axes[1].bar(labels2, [r["urgent_slo_attainment"] for r in pool_rows],
                color=["#888", "#2a7"])
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title(f"tight-SLO attainment ({URGENT_SLO_MS:.0f}ms class)")
    fig.suptitle("SLO-aware preemption + chunked prefill")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    smoke = profile().smoke
    n_steps = 60 if smoke else 240
    hog_tokens = 60 if smoke else 200   # hog residency (decode steps)
    n_urgent = 2 if smoke else 5
    eng_rows = [_run_engine_panel(None, n_steps, device),
                _run_engine_panel(TOKEN_BUDGET, n_steps, device)]
    for r in eng_rows:
        emit(f"fig_preempt.engine.budget{r['token_budget']}", 0.0,
             f"decode_p50={r['decode_p50_ms']:.2f}ms "
             f"p99={r['p99_ms']:.2f}ms max={r['max_ms']:.2f}ms")
    capped = eng_rows[1]
    bound = capped["p99_ms"] / max(capped["decode_p99_ms"], 1e-9)
    uncapped_bound = eng_rows[0]["p99_ms"] / max(
        eng_rows[0]["decode_p99_ms"], 1e-9)
    emit("fig_preempt.engine.p99_over_decode", 0.0,
         f"capped={bound:.2f}x uncapped={uncapped_bound:.2f}x")
    if not smoke:
        # acceptance: budgeted iterations stay within ~2x a pure-decode
        # iteration even while 512-token prompts are arriving
        check(bound <= 2.0, f"chunked p99 bound violated: {bound:.2f}x")

    pool_rows = [_run_pool_panel(False, hog_tokens, n_urgent, device),
                 _run_pool_panel(True, hog_tokens, n_urgent, device)]
    for r in pool_rows:
        emit(f"fig_preempt.pool.preempt{int(r['preemption'])}", 0.0,
             f"urgent_slo={r['urgent_slo_attainment']:.2f} "
             f"p99={r['urgent_p99_ms']:.0f}ms "
             f"n_preempted={r['n_preempted']} "
             f"identical={r['hog_token_identical']}")
    check(pool_rows[1]["hog_token_identical"],
          "preempt-resume output diverged from the uninterrupted run")
    if not smoke:
        check(pool_rows[1]["n_preempted"] > 0, "preemption never fired")
        check(pool_rows[1]["urgent_slo_attainment"]
              >= pool_rows[0]["urgent_slo_attainment"],
              "preemption did not improve tight-SLO attainment")

    payload = {"engine": eng_rows, "p99_over_decode_p99": bound,
               "pool": pool_rows, "token_budget": TOKEN_BUDGET,
               "long_prompt": LONG_PROMPT, "hog_tokens": hog_tokens,
               "urgent_slo_ms": URGENT_SLO_MS}
    emit("fig_preempt.json", 0.0,
         write_json("fig_preemption_chunked", payload))
    png_path = os.path.join(OUT_DIR, "fig_preemption_chunked.png")
    if _plot(eng_rows, pool_rows, png_path):
        emit("fig_preempt.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
