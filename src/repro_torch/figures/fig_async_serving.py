"""Beyond-paper figure: push-mode async serving under a flash crowd:
client-observed latency through the REAL HTTP front-end, backpressure
against accept-everything.

The full push-mode stack runs end to end: ``ServingDriver`` steps the
pool (on ``device``) on a background thread, ``ServingFrontend`` streams
per-token ndjson events over HTTP, and the closed-loop load generator
from ``repro_torch.serving.workload`` replays a flash-crowd arrival trace
(steady base load, then a sudden many-fold spike) with mixed SLO tiers
and client abandonment. Two policies face the same trace:

* **backpressure**: non-admissible requests past the queue-depth cap get
  ``429 + Retry-After`` (derived from the calibrated per-token cost over
  the queued work); clients honour the hint and retry.
* **accept-everything**: every request queues. During the spike the
  queue grows without bound, TTFT blows up, and clients abandon
  mid-stream (mass disconnect -> cancellation -> synchronous block
  free).

Asserted (the acceptance gates):

* client-observed TTFT p99 with backpressure <= 0.5x accept-everything
  at the full profile, <= 0.85x at the fast and smoke profiles, which
  replay the short trace;
* tight-tier SLO attainment strictly higher under backpressure at the
  full profile, not lower at the others (throttled clients COUNT against
  attainment: the 429s must be earned);
* zero leaked blocks / reservations after the run and after a deliberate
  mid-stream disconnect storm.

Artifacts: ``experiments/figures_torch/fig_async_serving.json`` (always)
and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_async_serving
"""
from __future__ import annotations

import asyncio
import os

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.launch.server import ServingFrontend
from repro_torch.serving.driver import ServingDriver
from repro_torch.serving.runtime import ModelInstancePool
from repro_torch.serving.workload import (ArrivalTrace, http_generate,
                                          make_trace_requests,
                                          run_closed_loop,
                                          summarize_outcomes)

CFG = ModelConfig(name="tiny-async", family="dense", n_layers=2,
                  d_model=48, n_heads=2, n_kv_heads=2, d_ff=96,
                  vocab_size=151)
MAX_SLOTS = 3
MAX_SEQ = 96
#: tiers are compressed against production (tight SLO ~ a few hundred ms
#: on a tiny model) so the whole figure runs in seconds; abandonment at
#: 4x SLO keeps the accept-everything tail bounded
TIERS = {"tight": (300.0, 0.3), "standard": (1200.0, 0.45),
         "relaxed": (5000.0, 0.25)}
ABANDON_FACTOR = 4.0


def _trace(short: bool) -> ArrivalTrace:
    """A short violent spike followed by a LONG base-load tail: the
    accept-everything backlog (relaxed clients are patient) keeps every
    slot busy for seconds after the spike, so post-flash tight arrivals
    miss their SLO, while the backpressure policy, whose queue never
    grew, serves them immediately."""
    if short:
        return ArrivalTrace.flash_crowd(10.0, base_rps=8.0,
                                        flash_rps=500.0,
                                        flash_start_frac=0.1,
                                        flash_frac=0.12)
    return ArrivalTrace.flash_crowd(14.0, base_rps=8.0, flash_rps=550.0,
                                    flash_start_frac=0.1,
                                    flash_frac=0.1)


def _leaked(pool: ModelInstancePool) -> dict:
    """Outstanding KV references across every live instance (must be
    zero once all clients have finished/disconnected and the driver has
    drained the resulting cancellations)."""
    live = reserved = 0
    for inst in pool.live():
        al = inst.engine.allocator
        if al is not None:
            live += al.n_live
            reserved += al.n_reserved
    queued = sum(len(q) for q in pool.queues.values())
    resident = sum(i.n_resident for i in pool.live())
    return {"n_live": live, "n_reserved": reserved,
            "n_queued": queued, "n_resident": resident}


async def _disconnect_storm(host: str, port: int, n: int,
                            seed: int) -> dict:
    """``n`` concurrent clients ask for long decodes and ALL hang up
    almost immediately: every client that started streaming must turn
    into a server-side cancel that frees its slot and blocks
    synchronously. (Under backpressure the late arrivals may be
    throttled at the door instead: also a valid non-leaking path.)"""
    rng = np.random.default_rng(seed)
    outs = await asyncio.gather(*(
        http_generate(host, port, CFG.name,
                      rng.integers(1, CFG.vocab_size, 12).astype(np.int32),
                      max_new_tokens=64, slo_ms=5000.0,
                      abandon_after_s=0.05 + 0.01 * i)
        for i in range(n)))
    counts = {}
    for o in outs:
        counts[o.outcome] = counts.get(o.outcome, 0) + 1
    return counts


async def _episode_async(backpressure: bool, short: bool, seed: int,
                         device="cuda") -> dict:
    pool = ModelInstancePool({CFG.name: CFG}, max_instances=1,
                             max_slots=MAX_SLOTS, max_seq=MAX_SEQ,
                             kv_layout="paged", block_size=8, seed=seed,
                             device=device)
    pool.scale_to(CFG.name, 1)
    pool.warmup(seed=seed)
    trace = _trace(short)
    reqs = make_trace_requests(trace, {CFG.name: CFG.vocab_size},
                               seed=seed, prompt_len=(8, 32),
                               max_new=(16, 28), tiers=TIERS,
                               abandon_factor=ABANDON_FACTOR)
    driver = ServingDriver(pool)
    # shallow admission queue: past depth 4 the EDF queue would keep
    # admitted patient-tier clients starved for seconds (tight arrivals
    # jump to the head), dragging the backpressure policy's own TTFT
    # tail up: reject at the door instead
    fe = ServingFrontend(driver, port=0, backpressure=backpressure,
                         max_queue_depth=3)
    driver.start()
    await fe.start()
    try:
        outcomes = await run_closed_loop("127.0.0.1", fe.port, reqs,
                                         retry_on_429=True, max_retries=1)
        storm_n = 6 if short else 12
        storm = await _disconnect_storm("127.0.0.1", fe.port, storm_n,
                                        seed)
        # the storm's cancels land synchronously, but give the loop one
        # breath to retire anything admitted in the same iteration
        await asyncio.get_running_loop().run_in_executor(
            None, driver.drain, 30.0)
    finally:
        await fe.stop()
        driver.stop()
    row = summarize_outcomes(outcomes)
    row.update({f"leak_{k}": float(v) for k, v in _leaked(pool).items()})
    stats = pool.stats()
    row.update({
        "policy": "backpressure" if backpressure else "accept_all",
        "n_requests": float(len(reqs)),
        "storm_n": float(storm_n),
        "storm_cancelled": float(storm.get("abandoned", 0)
                                 + storm.get("cancelled", 0)),
        "storm_throttled": float(storm.get("throttled", 0)),
        "storm_other": float(storm_n - sum(storm.get(k, 0) for k in
                                           ("abandoned", "cancelled",
                                            "throttled"))),
        "server_throttled": float(fe.n_throttled),
        "server_disconnects": float(fe.n_disconnects),
        "pool_cancelled": float(stats.get("n_cancelled", 0)),
        "pool_ttft_ms_p99": float(stats.get("ttft_ms_p99", 0.0)),
        "pool_tpot_ms_p99": float(stats.get("tpot_ms_p99", 0.0)),
    })
    return row


def _episode(backpressure: bool, short: bool, seed: int = 7,
             device="cuda") -> dict:
    return asyncio.run(_episode_async(backpressure, short, seed, device))


def _plot(bp: dict, aa: dict, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    labels = ["backpressure", "accept-all"]
    axes[0].bar(labels, [bp["ttft_ms_p99"], aa["ttft_ms_p99"]],
                color=["tab:green", "tab:red"])
    axes[0].set_title("client TTFT p99 (ms)")
    for i, tier in enumerate(("tight", "standard", "relaxed")):
        axes[1].bar(np.arange(2) + (i - 1) * 0.25,
                    [bp.get(f"attainment_{tier}", 0.0),
                     aa.get(f"attainment_{tier}", 0.0)],
                    width=0.25, label=tier)
    axes[1].set_xticks(range(2), labels)
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title("SLO attainment by tier")
    axes[1].legend()
    kinds = ("finished", "throttled", "abandoned", "cancelled")
    for i, row in enumerate((bp, aa)):
        bottom = 0.0
        for kind in kinds:
            v = row[f"n_{kind}"]
            axes[2].bar([labels[i]], [v], bottom=bottom,
                        color=f"C{kinds.index(kind)}",
                        label=kind if i == 0 else None)
            bottom += v
    axes[2].set_title("client outcomes")
    axes[2].legend()
    fig.suptitle("flash crowd through the async HTTP front-end")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def _median_row(rows: list) -> dict:
    out = dict(rows[0])
    for k in ("ttft_ms_p99", "ttft_ms_p50", "tpot_ms_p99",
              "attainment_tight", "attainment_standard",
              "attainment_relaxed"):
        if k in rows[0]:
            out[k] = float(np.median([r[k] for r in rows]))
    return out


def main(device="cuda") -> dict:
    # the fast profile replays the short (smoke) trace; the gates hold at
    # both scales, the full profile runs the longer one
    short = profile().fast
    # wall-clock episodes are noisy (single runs spread the TTFT-p99
    # ratio roughly 0.35-0.55); full scale runs 3 seeds per policy and
    # gates on the per-policy MEDIANS, the short trace keeps one seed
    seeds = [7] if short else [7, 17, 27]
    bp_rows = [_episode(True, short, s, device) for s in seeds]
    aa_rows = [_episode(False, short, s, device) for s in seeds]
    bp, aa = _median_row(bp_rows), _median_row(aa_rows)
    for row in (bp, aa):
        emit(f"fig_async.{row['policy']}", 0.0,
             f"ttft_p99={row['ttft_ms_p99']:.0f}ms "
             f"tight={row.get('attainment_tight', 0.0):.2f} "
             f"fin={row['n_finished']:.0f}/{row['n']:.0f} "
             f"429={row['n_throttled']:.0f} "
             f"abandon={row['n_abandoned']:.0f}")

    # ---- acceptance gates ----------------------------------------------
    for row in bp_rows + aa_rows:  # structural gates: every episode
        check(row["leak_n_live"] == 0 and row["leak_n_reserved"] == 0,
              f"{row['policy']}: leaked blocks after mass disconnect "
              f"(live={row['leak_n_live']} "
              f"reserved={row['leak_n_reserved']})")
        check(row["storm_other"] == 0,
              f"{row['policy']}: storm client finished or errored "
              f"(cancelled={row['storm_cancelled']} "
              f"throttled={row['storm_throttled']})")
        check(row["storm_cancelled"] >= MAX_SLOTS,
              f"{row['policy']}: too few mid-stream disconnects "
              f"propagated ({row['storm_cancelled']})")
    ratio = bp["ttft_ms_p99"] / max(aa["ttft_ms_p99"], 1e-9)
    # the wall-clock gates: hard on the long trace; the 10x-shorter one
    # keeps the direction but its margins are thin enough that contention
    # on a shared host can push them around, so it only asserts
    # better-not-worse
    max_ratio = 0.85 if short else 0.5
    check(ratio <= max_ratio,
          f"backpressure TTFT p99 not <= {max_ratio}x accept-all "
          f"(ratio={ratio:.2f})")
    if short:
        check(bp["attainment_tight"] >= aa["attainment_tight"],
              f"tight-tier attainment regressed "
              f"({bp['attainment_tight']:.2f} vs "
              f"{aa['attainment_tight']:.2f})")
    else:
        check(bp["attainment_tight"] > aa["attainment_tight"],
              f"tight-tier attainment not improved "
              f"({bp['attainment_tight']:.2f} vs "
              f"{aa['attainment_tight']:.2f})")
    emit("fig_async.gates", 0.0,
         f"ttft_ratio={ratio:.2f} "
         f"tight={bp['attainment_tight']:.2f}>"
         f"{aa['attainment_tight']:.2f} leaks=0")

    payload = {"smoke": short, "tiers": TIERS,
               "abandon_factor": ABANDON_FACTOR,
               "seeds": seeds,
               "backpressure": bp, "accept_all": aa,
               "backpressure_seeds": bp_rows, "accept_all_seeds": aa_rows,
               "ttft_p99_ratio": ratio}
    emit("fig_async.json", 0.0, write_json("fig_async_serving", payload))
    png_path = os.path.join(OUT_DIR, "fig_async_serving.png")
    if _plot(bp, aa, png_path):
        emit("fig_async.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
