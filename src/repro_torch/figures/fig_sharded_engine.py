"""Beyond-paper figure: what TP degree buys a KV-tight pool.

The scheduler's fifth axis is the TP degree: a degree-d instance spans d
devices of the shared set, head-sharding its paged block pool over the
mesh's model axis. Because each KV block is spread over d devices, the
pool charges a degree-d instance only ``ceil(grant/d)`` blocks of the
SHARED per-device budget while the engine keeps the full grant: one
budget block buys d pool blocks. On a budget-bound pool that is the
capacity the guard trades against the collective surcharge
(``tp_collective_ms_per_token``) when it prices the layout.

Measured panel: two pools on ``device`` drain the SAME decode-heavy
trace under the same tight ``kv_block_budget``, one pinned to the
tp_degrees=(1,) layout, one at the tp_degree=2 layout the guard may pick.
The reference runs this panel in a subprocess only to force two host
devices; here both pools run in process, the tp = 2 one on a
``("model",)`` mesh that names ``device`` twice (both shards on one card
on the GPU, on the host CPU otherwise: the budget is per device, the
card's time is both shards'). Engine admission reserves worst-case
blocks per request, so the tp=1 pool holds half the residents and its
queue waits double; goodput (requests served within SLO per second) and
per-request Eq.-3 utility, both computed from wall-clock latency
including queue wait, should improve at tp=2 despite the slower sharded
step. Each layout drains the trace ``n_reps`` times (interleaved, pools
reused so kernel builds stay out of the measured region) and the median
drain is reported.

Analytic panel: per-degree KV capacity multiplier and the collective
surcharge for the 7B-ish shape from ``roofline_table.TP_SHAPES``,
showing the trade the guard prices (NVLink 4 data-sheet rate, fp32
payload: the port's guard).

Asserted (the acceptance bar, fast and full profiles): tp=2 goodput AND
mean utility strictly above the tp_degrees=(1,) layout on the same
trace.

Artifacts: ``experiments/figures_torch/fig_sharded_engine.json``
(always) and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_sharded_engine
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.figures.roofline_table import TP_SHAPES
from repro_torch.serving.bcedge import tp_collective_ms_per_token
from repro_torch.serving.runtime import ModelInstancePool

TINY = ModelConfig(name="tiny-tp", family="dense", n_layers=2,
                   d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                   vocab_size=97)

PROMPT_LEN = 24
KV_BUDGET = 40          # blocks: tight, the binding resource
SLO_MS = 600_000.0      # generous: goodput == drained throughput


class Scale(NamedTuple):
    """``n_req`` requests of ``max_new`` tokens a drain, ``n_reps``
    interleaved drains per layout (the median is reported)."""
    n_req: int
    max_new: int
    n_reps: int


FULL = Scale(32, 40, 5)
#: toy scale: the code paths, not the numbers
SMOKE = Scale(6, 8, 1)


def _make_pool(tp: int, scale: Scale, rng, device="cuda"):
    pool = ModelInstancePool({TINY.name: TINY}, max_instances=2,
                             max_slots=12, max_seq=128,
                             kv_layout="paged", block_size=8,
                             kv_block_budget=KV_BUDGET,
                             tp_degree=tp, n_devices=2, seed=0,
                             tp_devices=[device] * 2, device=device)
    check(pool.scale_to(TINY.name, 1) == 1, f"tp={tp}: no instance spawned")
    # the warm pass builds prefill/decode for this layout: every measured
    # drain below reuses the pool, so no build lands inside a makespan
    for _ in range(2):
        pool.submit(TINY.name, rng.integers(1, 97, PROMPT_LEN)
                    .astype(np.int32), slo_ms=SLO_MS,
                    max_new_tokens=scale.max_new)
    pool.run_until_drained()
    return pool


def _drain_once(pool, scale: Scale, rng) -> dict:
    rids = {pool.submit(TINY.name,
                        rng.integers(1, 97, PROMPT_LEN).astype(np.int32),
                        slo_ms=SLO_MS, max_new_tokens=scale.max_new)
            for _ in range(scale.n_req)}
    pool.run_until_drained(max_steps=50_000)
    rs = [r for r in pool.results(TINY.name) if r.request_id in rids]
    check(len(rs) == scale.n_req and not any(r.rejected for r in rs),
          f"{len(rs)}/{scale.n_req} served, or some rejected")
    makespan = max(r.finish_s for r in rs) - min(r.submit_s for r in rs)
    good = [r for r in rs if not r.violated]
    lat = [r.latency_ms for r in rs]
    return {"goodput_rps": len(good) / makespan,
            "mean_utility": float(np.mean([r.utility for r in rs])),
            "mean_latency_ms": float(np.mean(lat)),
            "p95_latency_ms": float(np.percentile(lat, 95)),
            "makespan_s": makespan}


def _summarize(pool, reps: list, scale: Scale) -> dict:
    # per-metric median over the drains: one slow-machine blip cannot
    # flip the layout comparison
    med = {k: float(np.median([r[k] for r in reps])) for k in reps[0]}
    inst = pool.running(TINY.name)[0]
    per_req = inst.engine.request_blocks(PROMPT_LEN, scale.max_new)
    out = dict(med)
    out.update({
        "tp": inst.tp_degree,
        "kv_charge_blocks": inst.kv_blocks,
        "kv_pool_blocks": inst.engine.allocator.n_blocks,
        "resident_capacity": inst.engine.allocator.n_blocks // per_req,
        "reps": reps})
    return out


def _measure(scale: Scale, device="cuda") -> dict:
    rng = np.random.default_rng(3)
    pools = {1: _make_pool(1, scale, rng, device),
             2: _make_pool(2, scale, rng, device)}
    reps = {1: [], 2: []}
    # interleave the layouts' drains so machine-load drift hits both
    for _ in range(scale.n_reps):
        for tp in (1, 2):
            reps[tp].append(_drain_once(pools[tp], scale, rng))
    return {"tp1": _summarize(pools[1], reps[1], scale),
            "tp2": _summarize(pools[2], reps[2], scale)}


def _analytic() -> list:
    """Per-degree capacity multiplier vs collective surcharge for the
    7B server shape: the two sides of the guard's layout price."""
    label, cfg, b, ctx = TP_SHAPES[0]
    return [{"shape": label, "tp": d, "kv_capacity_x": float(d),
             "collective_ms_per_token": tp_collective_ms_per_token(cfg, d)}
            for d in (1, 2, 4, 8)]


def _plot(meas: dict, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(9, 4))
    labels = ["tp_degrees=(1,)", "guard picks tp=2"]
    colors = ["#888", "#2a7"]
    rows = [meas["tp1"], meas["tp2"]]
    ax.bar(labels, [r["goodput_rps"] for r in rows], color=colors)
    for i, r in enumerate(rows):
        ax.text(i, r["goodput_rps"],
                f"{r['resident_capacity']} resident\n"
                f"{r['kv_pool_blocks']} blocks", ha="center", va="bottom")
    ax.set_ylabel("goodput (req/s within SLO)")
    ax.set_title("same trace, same shared KV budget")
    ax2.bar(labels, [r["mean_latency_ms"] for r in rows], color=colors)
    ax2.set_ylabel("mean latency ms (incl. queue wait)")
    ax2.set_title("queue wait under the block budget")
    fig.suptitle("TP degree as a scheduler axis on a KV-tight pool")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    smoke = profile().smoke
    scale = SMOKE if smoke else FULL

    meas = _measure(scale, device)
    t1, t2 = meas["tp1"], meas["tp2"]
    for k, r in (("tp1", t1), ("tp2", t2)):
        emit(f"fig_sharded.{k}", 0.0,
             f"goodput={r['goodput_rps']:.2f}rps "
             f"utility={r['mean_utility']:.3f} "
             f"lat={r['mean_latency_ms']:.0f}ms "
             f"residents={r['resident_capacity']} "
             f"blocks={r['kv_pool_blocks']}")
    emit("fig_sharded.gain", 0.0,
         f"goodput={t2['goodput_rps']/max(t1['goodput_rps'],1e-9):.2f}x "
         f"capacity={t2['kv_pool_blocks']}/{t1['kv_pool_blocks']}blocks")
    if not smoke:
        # the acceptance bar
        check(t2["goodput_rps"] > t1["goodput_rps"],
              f"tp=2 goodput {t2['goodput_rps']:.3f} not above "
              f"tp_degrees=(1,) {t1['goodput_rps']:.3f}")
        check(t2["mean_utility"] > t1["mean_utility"],
              f"tp=2 utility {t2['mean_utility']:.4f} not above "
              f"tp_degrees=(1,) {t1['mean_utility']:.4f}")

    arows = _analytic()
    emit("fig_sharded.analytic", 0.0,
         f"{arows[0]['shape']}: " + " ".join(
             f"tp{r['tp']}={r['collective_ms_per_token']*1e3:.0f}us/tok"
             for r in arows[1:]))

    payload = {"n_req": scale.n_req, "max_new": scale.max_new,
               "prompt_len": PROMPT_LEN, "kv_budget": KV_BUDGET,
               "measured": meas, "analytic": arows}
    emit("fig_sharded.json", 0.0, write_json("fig_sharded_engine", payload))
    png_path = os.path.join(OUT_DIR, "fig_sharded_engine.png")
    if _plot(meas, png_path):
        emit("fig_sharded.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
