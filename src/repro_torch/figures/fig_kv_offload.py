"""Beyond-paper figure: the host-memory KV offload tier under preemption.

Two pools on the same workload, differing only in ``preempt_mode``. A
single paged instance with a constrained device block budget serves two
long-context batch requests (the "hogs") whose SLO is sized to absorb
preemption waits and swap round-trips but NOT context replays, while a
stream of tight-SLO urgent requests arrives and preempts them:

- **recompute** frees each victim's blocks; on resume the whole 256+
  token context re-prefills through the chunked-prefill budget (32+
  iterations at ``TOKEN_BUDGET=8``): the hog pays the replay and blows
  its deadline.
- **swap** copies the victim's blocks to the instance's host tier of
  pinned memory; resume copies them back and decodes on the next
  iteration, so the hog's deadline survives the same preemption churn.

The pools run on ``device``; on the GPU the resumes' chunks attend the
pool through ``paged_prefill_attention`` and decode runs split-K.

Asserted (the acceptance bar):

1. tight-SLO attainment of the preempted class with swap strictly
   beats recompute-only (aggregated over ``trials`` runs per mode),
   fast and full profiles, where preemption must also fire, swap must
   swap and recompute must not;
2. swap-resume output is token-identical to recompute-resume (both are
   checked against an uninterrupted reference run);
3. zero blocks, device or host, leak after drain.

Artifacts: ``experiments/figures_torch/fig_kv_offload.json`` (always)
and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_kv_offload
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

TINY = ModelConfig(name="tiny-offload", family="dense", n_layers=4,
                   d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                   vocab_size=211)

CACHE_LEN = 512
BLOCK_SIZE = 8
# two full hog contexts + an urgent fit, but nothing is free: a swapped
# hog's blocks must round-trip through the host tier to come back
KV_BLOCK_BUDGET = 128
KV_HOST_BLOCKS = 128
TOKEN_BUDGET = 8           # chunked re-prefill: the cost swap avoids
HOG_PROMPT = 248           # left-pads to the 256 bucket -> 32+ blocks
HOG_SLO_MS = 2000.0        # ~4x uninterrupted: absorbs preempt waits +
                           # swap round-trips, not 256-token replays
N_URGENT = 2
URGENT_PROMPT = 24
URGENT_TOKENS = 16         # enough predicted service time that the
                           # preempt trigger fires near arrival
URGENT_SLO_MS = 300.0
URGENT_EVERY_S = 0.5


def _two_tier_leaks(pool) -> dict:
    """Post-drain two-tier conservation over every live paged engine."""
    dev_live = host_live = 0
    dev_ok = host_ok = True
    for insts in pool.instances.values():
        for inst in insts:
            al = getattr(inst.engine, "allocator", None)
            if al is None:
                continue
            dev_live += al.n_live
            host_live += al.n_host_live
            dev_ok &= al.n_free + al.n_cached + al.n_live == al.n_blocks
            host_ok &= (al.n_host_free + al.n_host_cached +
                        al.n_host_live == al.n_host_blocks)
    return {"device_live": dev_live, "host_live": host_live,
            "device_conserved": bool(dev_ok),
            "host_conserved": bool(host_ok)}


def _run_trial(mode: str, ref: np.ndarray, hog_prompt: np.ndarray,
               seed: int, hog_tokens: int, device="cuda") -> dict:
    """One hog/urgent contention run under one preempt mode."""
    pool = ModelInstancePool({TINY.name: TINY}, max_instances=1,
                             max_slots=2, max_seq=CACHE_LEN, seed=0,
                             kv_layout="paged", block_size=BLOCK_SIZE,
                             kv_block_budget=KV_BLOCK_BUDGET,
                             kv_host_blocks=KV_HOST_BLOCKS,
                             token_budget=TOKEN_BUDGET,
                             preemption=True, max_preemptions=100,
                             preempt_cooldown_steps=4,
                             preempt_mode=mode, device=device)
    pool.scale_to(TINY.name, 1)
    pool.warmup(seed=0)
    rng = np.random.default_rng(seed)
    # calibrate the contention fit (the preemption trigger needs it) and
    # warm the long-prompt prefill shapes before measurement
    for _ in range(2):
        pool.submit(TINY.name, hog_prompt, slo_ms=60_000.0,
                    max_new_tokens=4)
    pool.run_until_drained()

    hogs = [pool.submit(TINY.name, hog_prompt, slo_ms=HOG_SLO_MS,
                        max_new_tokens=hog_tokens) for _ in range(2)]
    urgent_ids = []
    next_urgent = URGENT_EVERY_S
    t0 = pool.now()
    done = []
    for _ in range(100_000):
        if len(urgent_ids) < N_URGENT and pool.now() - t0 >= next_urgent:
            urgent_ids.append(pool.submit(
                TINY.name,
                rng.integers(1, TINY.vocab_size, URGENT_PROMPT).astype(
                    np.int32),
                slo_ms=URGENT_SLO_MS, max_new_tokens=URGENT_TOKENS))
            next_urgent += URGENT_EVERY_S
        done.extend(pool.step())
        if len(done) == len(hogs) + N_URGENT and len(urgent_ids) == N_URGENT:
            break
    by_id = {r.request_id: r for r in done}
    urgent = [by_id[i] for i in urgent_ids]
    hog_res = [by_id[i] for i in hogs]
    leaks = _two_tier_leaks(pool)
    stats = pool.stats()
    return {
        "mode": mode,
        "seed": seed,
        "n_preempted": pool.n_preempted,
        "n_swap_preempted": pool.n_swap_preempted,
        "hog_latency_ms": [float(r.latency_ms) for r in hog_res],
        "hog_met": [bool(not r.violated) for r in hog_res],
        "urgent_met": [bool(not r.violated) for r in urgent],
        "urgent_latency_ms": [float(r.latency_ms) for r in urgent],
        "hog_token_identical": bool(all(
            np.array_equal(r.tokens, ref) for r in hog_res)),
        "wall_s": float(pool.now() - t0),
        "swap_base_ms": float(stats.get("swap_base_ms", 0.0)),
        "swap_ms_per_mb": float(stats.get("swap_ms_per_mb", 0.0)),
        **leaks,
    }


def _aggregate(trials: list) -> dict:
    hogs_met = [m for t in trials for m in t["hog_met"]]
    urg_met = [m for t in trials for m in t["urgent_met"]]
    return {
        "mode": trials[0]["mode"],
        "hog_slo_attainment": float(np.mean(hogs_met)),
        "urgent_slo_attainment": float(np.mean(urg_met)),
        "hog_latency_max_ms": float(max(
            x for t in trials for x in t["hog_latency_ms"])),
        "n_preempted": sum(t["n_preempted"] for t in trials),
        "n_swap_preempted": sum(t["n_swap_preempted"] for t in trials),
        "token_identical": all(t["hog_token_identical"] for t in trials),
        "trials": trials,
    }


def _plot(rows: list, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 2, figsize=(8, 3.5))
    labels = [r["mode"] for r in rows]
    axes[0].bar(labels, [r["hog_slo_attainment"] for r in rows],
                color=["#888", "#2a7"])
    axes[0].set_ylim(0, 1.05)
    axes[0].set_title(
        f"preempted-class attainment ({HOG_SLO_MS:.0f}ms SLO)")
    for r, xs in zip(rows, ([0.9, 1.1], [1.9, 2.1])):
        lats = [x for t in r["trials"] for x in t["hog_latency_ms"]]
        axes[1].scatter([xs[i % 2] for i in range(len(lats))], lats,
                        label=r["mode"], s=18)
    axes[1].axhline(HOG_SLO_MS, color="#c33", ls="--", lw=1,
                    label="SLO")
    axes[1].set_ylabel("hog completion ms")
    axes[1].set_xticks([1, 2], labels)
    axes[1].set_title("replay cost vs swap round-trip")
    axes[1].legend(fontsize=7)
    fig.suptitle("KV offload: swap-resume vs recompute-resume")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    smoke = profile().smoke
    hog_tokens = 40 if smoke else 160
    trials_n = 1 if smoke else 3
    rng = np.random.default_rng(1)
    hog_prompt = rng.integers(1, TINY.vocab_size, HOG_PROMPT).astype(
        np.int32)
    # uninterrupted reference completion for the token-identity check
    ref = ContinuousBatchingEngine(
        TINY, max_slots=2, max_seq=CACHE_LEN, seed=0, kv_layout="paged",
        block_size=BLOCK_SIZE, device=device).run(
            [hog_prompt], max_new_tokens=hog_tokens)[0].tokens

    rows = []
    for mode in ("recompute", "swap"):
        trials = [_run_trial(mode, ref, hog_prompt, 2 + k, hog_tokens,
                             device) for k in range(trials_n)]
        rows.append(_aggregate(trials))
    for r in rows:
        emit(f"fig_kv_offload.{r['mode']}", 0.0,
             f"hog_slo={r['hog_slo_attainment']:.2f} "
             f"urgent_slo={r['urgent_slo_attainment']:.2f} "
             f"hog_max={r['hog_latency_max_ms']:.0f}ms "
             f"preempts={r['n_preempted']} "
             f"swaps={r['n_swap_preempted']} "
             f"identical={r['token_identical']}")
    rec, swp = rows

    # acceptance 2: both resume flavours replay to the same completion
    # as the uninterrupted run, so swap-resume == recompute-resume
    check(rec["token_identical"],
          "recompute-resume diverged from the uninterrupted reference")
    check(swp["token_identical"],
          "swap-resume diverged from the uninterrupted reference")
    # acceptance 3: nothing leaks in either tier after drain
    for r in rows:
        for t in r["trials"]:
            check(t["device_live"] == 0 and t["host_live"] == 0,
                  f"{r['mode']}: live blocks survived drain")
            check(t["device_conserved"] and t["host_conserved"],
                  f"{r['mode']}: block conservation violated post-drain")
    if not smoke:
        check(rec["n_preempted"] > 0 and swp["n_preempted"] > 0,
              "preemption never fired: the workload lost its contention")
        check(swp["n_swap_preempted"] > 0, "swap mode never swapped")
        check(rec["n_swap_preempted"] == 0, "recompute mode swapped")
        # acceptance 1: the preempted class strictly gains from not
        # paying the chunked context replay on every resume
        check(swp["hog_slo_attainment"] > rec["hog_slo_attainment"],
              f"swap did not beat recompute: "
              f"{swp['hog_slo_attainment']:.2f} vs "
              f"{rec['hog_slo_attainment']:.2f}")

    payload = {"rows": rows, "hog_prompt": HOG_PROMPT,
               "hog_tokens": hog_tokens, "hog_slo_ms": HOG_SLO_MS,
               "n_urgent": N_URGENT, "urgent_slo_ms": URGENT_SLO_MS,
               "token_budget": TOKEN_BUDGET,
               "kv_block_budget": KV_BLOCK_BUDGET,
               "kv_host_blocks": KV_HOST_BLOCKS, "trials": trials_n}
    emit("fig_kv_offload.json", 0.0, write_json("fig_kv_offload", payload))
    png_path = os.path.join(OUT_DIR, "fig_kv_offload.png")
    if _plot(rows, png_path):
        emit("fig_kv_offload.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
