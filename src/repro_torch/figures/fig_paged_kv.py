"""Beyond-paper figure: paged vs dense KV-cache memory management.

Two panels, both on a decode-heavy workload (short prompts, long
decodes: the regime where dense per-slot slabs waste the most cache):

1. **Resident capacity**: one `ContinuousBatchingEngine` per layout
   under the SAME token budget. Dense commits `cache_len` tokens per
   slot, so the budget caps the slot count; paged only occupies the
   blocks a sequence actually needs, so the same budget holds >=1.5x
   (typically ~4x) more concurrently resident sequences. Reported as
   peak resident sequences, sequences-per-GB (using the model's
   analytic KV bytes/token), and the engines' own `kv_waste_frac`.

2. **Pool concurrency vs m_c**: a `ModelInstancePool` per layout under
   the SAME shared block budget, every model pinned at m_c instances,
   draining a fixed request burst (closed loop, so the numbers do not
   depend on how loaded the host happens to be). Dense instances must
   fit their whole slab in the budget, so `scale_to` clamps at m_c=1;
   paged instances take right-sized grants and the pool admits on real
   free-block counts, so the same budget reaches m_c=4: more resident
   sequences, shorter queue waits, higher per-request utility.

The engines run on ``device``: on the GPU, paged prefill and paged
decode (or split-K) serve the paged layout, dense decode the dense one.

Artifacts: ``experiments/figures_torch/fig_paged_kv.json`` (always) and
``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_paged_kv
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

TINY = ModelConfig(name="tiny-paged", family="dense", n_layers=2,
                   d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                   vocab_size=211)

BLOCK_SIZE = 16
CACHE_LEN = 256            # per-sequence max (what dense commits per slot)
BUDGET_TOKENS = 2048       # shared KV token budget for both layouts
MAX_NEW = 16               # decode-heavy: prompts 4..12 tokens
N_REQUESTS = 64

POOL_MAX_SEQ = 128
POOL_MAX_SLOTS = 2
POOL_BUDGET_BLOCKS = 16    # 256 tokens: ONE dense slab, 4 right-sized grants
M_C_SWEEP = (1, 2, 3, 4)
POOL_SLO_MS = 2000.0       # burst drain: deadlines generous, latency ranks
POOL_BURST = 48


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Analytic f32 KV bytes per cache token (linear attention layers)."""
    n_kv_layers = sum(1 for k in cfg.layer_kinds()
                      if k in ("attn", "attn_dense")
                      and cfg.sliding_window is None)
    return n_kv_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4


def _run_engine(layout: str, n_requests: int = N_REQUESTS, seed: int = 0,
                device="cuda") -> dict:
    """Drain ``n_requests`` short prompts through one engine whose KV
    memory is capped at BUDGET_TOKENS; track peak residency and waste."""
    if layout == "dense":
        eng = ContinuousBatchingEngine(TINY,
                                       max_slots=BUDGET_TOKENS // CACHE_LEN,
                                       max_seq=CACHE_LEN, device=device)
    else:
        eng = ContinuousBatchingEngine(TINY, max_slots=32,
                                       max_seq=CACHE_LEN,
                                       kv_layout="paged",
                                       block_size=BLOCK_SIZE,
                                       kv_blocks=BUDGET_TOKENS // BLOCK_SIZE,
                                       device=device)
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        eng.submit(rng.integers(1, TINY.vocab_size,
                                rng.integers(4, 13)).astype(np.int32),
                   max_new_tokens=MAX_NEW)
    peak_resident = 0
    waste = []
    t0 = time.perf_counter()
    n_done = 0
    while (eng.waiting or eng.active_slots) and eng.n_iters < 10_000:
        n_done += len(eng.step())
        peak_resident = max(peak_resident, len(eng.active_slots))
        waste.append(eng.stats()["kv_waste_frac"])
    dur_s = time.perf_counter() - t0
    check(n_done == n_requests, f"{layout}: {n_done}/{n_requests} served")
    budget_gb = BUDGET_TOKENS * kv_bytes_per_token(TINY) / 1e9
    return {
        "layout": layout,
        "budget_tokens": BUDGET_TOKENS,
        "peak_resident": peak_resident,
        "sequences_per_gb": peak_resident / budget_gb,
        "mean_kv_waste_frac": float(np.mean(waste)),
        "n_iters": eng.n_iters,
        "throughput_rps": n_done / max(dur_s, 1e-6),
    }


def _run_pool_point(layout: str, m_c: int, burst: int = POOL_BURST,
                    seed: int = 0, m_c_max: int = max(M_C_SWEEP),
                    device="cuda") -> dict:
    """Drain a fixed burst through a fixed (layout, m_c) allocation
    under the shared block budget (closed loop)."""
    kw = dict(kv_block_budget=POOL_BUDGET_BLOCKS, block_size=BLOCK_SIZE)
    if layout == "paged":
        # right-size the grant to the workload (prompt bucket + decode
        # tokens per slot) instead of the dense-equivalent slab
        per_slot = -(-(16 + MAX_NEW) // BLOCK_SIZE)
        kw.update(kv_layout="paged",
                  blocks_per_instance=POOL_MAX_SLOTS * per_slot)
    pool = ModelInstancePool({TINY.name: TINY}, max_instances=m_c_max,
                             max_slots=POOL_MAX_SLOTS, max_seq=POOL_MAX_SEQ,
                             seed=seed, device=device, **kw)
    reached = pool.scale_to(TINY.name, m_c)
    pool.warmup(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(burst):
        pool.submit(TINY.name,
                    rng.integers(1, TINY.vocab_size,
                                 rng.integers(4, 13)).astype(np.int32),
                    slo_ms=POOL_SLO_MS, max_new_tokens=MAX_NEW)
    peak_resident = 0
    done = []
    t0 = time.perf_counter()
    steps = 0
    while len(done) < burst and steps < 20_000:
        done.extend(pool.step())
        peak_resident = max(peak_resident,
                            sum(i.n_resident for i in pool.live()))
        steps += 1
    check(len(done) == burst,
          f"{layout} m_c={m_c}: {len(done)}/{burst} drained in {steps} steps")
    makespan_s = time.perf_counter() - t0
    lats = [r.latency_ms for r in done if not r.rejected]
    occ = pool.kv_occupancy()
    return {
        "layout": layout, "m_c_requested": m_c, "m_c_reached": reached,
        "peak_resident": peak_resident,
        "makespan_s": makespan_s,
        "throughput_rps": burst / max(makespan_s, 1e-6),
        "p50_latency_ms": float(np.percentile(lats, 50)) if lats else 0.0,
        "mean_utility": float(np.mean(
            [r.utility for r in done if not r.rejected])) if lats else 0.0,
        "free_blocks": occ["free_blocks"],
        "tokens_per_seq": occ["tokens_per_seq"],
    }


def _plot(cap_rows: list, pool_rows: list, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    layouts = [r["layout"] for r in cap_rows]
    axes[0].bar(layouts, [r["sequences_per_gb"] for r in cap_rows],
                color=["#888", "#2a7"])
    axes[0].set_title("resident sequences per GB of KV")
    axes[1].bar(layouts, [r["mean_kv_waste_frac"] for r in cap_rows],
                color=["#888", "#2a7"])
    axes[1].set_title("mean KV waste fraction")
    for layout, marker in (("dense", "s"), ("paged", "o")):
        rows = [r for r in pool_rows if r["layout"] == layout]
        axes[2].plot([r["m_c_requested"] for r in rows],
                     [r["peak_resident"] for r in rows],
                     marker=marker, label=f"{layout} resident")
        axes[2].plot([r["m_c_requested"] for r in rows],
                     [r["m_c_reached"] for r in rows],
                     marker=marker, linestyle="--",
                     label=f"{layout} m_c reached")
    axes[2].set_xlabel("m_c requested (shared block budget)")
    axes[2].set_title("pool concurrency under one budget")
    axes[2].legend(fontsize=7)
    fig.suptitle(f"paged vs dense KV under a {BUDGET_TOKENS}-token budget")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    prof = profile()
    fast = prof.fast
    n_requests, m_c_sweep = (8, (1, 2)) if prof.smoke \
        else (N_REQUESTS, M_C_SWEEP)
    cap_rows = [_run_engine("dense", n_requests, device=device),
                _run_engine("paged", n_requests, device=device)]
    for r in cap_rows:
        emit(f"fig_paged.capacity.{r['layout']}", 0.0,
             f"peak={r['peak_resident']} "
             f"seq/GB={r['sequences_per_gb']:.0f} "
             f"waste={r['mean_kv_waste_frac']:.2f}")
    ratio = cap_rows[1]["peak_resident"] / max(1, cap_rows[0]["peak_resident"])
    emit("fig_paged.capacity.ratio", 0.0, f"{ratio:.2f}x")

    burst = 8 if prof.smoke else (POOL_BURST if fast else 3 * POOL_BURST)
    pool_rows = []
    for layout in ("dense", "paged"):
        for m_c in m_c_sweep:
            row = _run_pool_point(layout, m_c, burst,
                                  m_c_max=max(m_c_sweep), device=device)
            pool_rows.append(row)
            emit(f"fig_paged.pool.{layout}.mc{m_c}", 0.0,
                 f"reached={row['m_c_reached']} "
                 f"resident={row['peak_resident']} "
                 f"p50={row['p50_latency_ms']:.0f}ms "
                 f"u={row['mean_utility']:.2f}")

    # headline: at the largest requested m_c, how many sequences the two
    # layouts actually keep resident under the SAME block budget
    top = {layout: max((r for r in pool_rows if r["layout"] == layout),
                       key=lambda r: r["m_c_requested"])
           for layout in ("dense", "paged")}
    pool_ratio = top["paged"]["peak_resident"] \
        / max(1, top["dense"]["peak_resident"])
    emit("fig_paged.pool.resident_ratio", 0.0, f"{pool_ratio:.2f}x")

    payload = {"budget_tokens": BUDGET_TOKENS, "block_size": BLOCK_SIZE,
               "cache_len": CACHE_LEN, "max_new_tokens": MAX_NEW,
               "capacity": cap_rows, "capacity_ratio": ratio,
               "pool_budget_blocks": POOL_BUDGET_BLOCKS,
               "pool": pool_rows, "pool_resident_ratio": pool_ratio}
    emit("fig_paged.json", 0.0, write_json("fig_paged_kv", payload))
    png_path = os.path.join(OUT_DIR, "fig_paged_kv.png")
    if _plot(cap_rows, pool_rows, png_path):
        emit("fig_paged.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
