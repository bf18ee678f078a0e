"""Rate sweep of the multi-model instance pool: ``serve_pool`` at a fixed
grid of Poisson rates, each window long enough to serve some hundreds of
tokens, with per-request latency percentiles and how many instances held
sequences at once. Prints one JSON object per configuration and writes
them, one per line, to ``--out``.

    PYTHONPATH=src python -m repro_torch.launch.pool_sweep \\
        --out pool_sweep.jsonl > pool_sweep.log

``GRID`` is the paged pool that ``chip_smoke.py`` drives (qwen3-0.6b at
full width, a 500-token shared system prompt plus an 8-token tail, 32
new tokens, SLO 5 s, b <= 4, m_c <= 4 under a 576-block budget) at 0.125
to 1.5 requests/s, and the dense pool of qwen3-0.6b with
recurrentgemma-2b at full width (4 new tokens, SLO 2 s) at 6 and 12
requests/s. ``--prefix-cache`` reruns the grid with the paged pool's
prefix cache on (every request then shares its system prompt's blocks);
``--rps 0.25,0.5`` keeps only those rates. ``--smoke`` runs two short
configurations at reduced width (``--device cpu`` runs them on the CPU).
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
from typing import Dict, List, Sequence

import numpy as np

PAGED = dict(models=("qwen3-0.6b",), kv_layout="paged",
             shared_prefix_tokens=500, max_instances=4, max_slots=4,
             max_new_tokens=32, slo_ms=5000.0, kv_block_budget=576)
DENSE = dict(models=("qwen3-0.6b", "recurrentgemma-2b"), kv_layout="dense",
             max_instances=4, max_slots=4, max_new_tokens=4, slo_ms=2000.0)

#: (label, pool, requests/s, window s): every paged window expects at
#: least 20 arrivals (640 requested tokens), every dense one 180
GRID = (("paged", PAGED, 0.125, 160.0), ("paged", PAGED, 0.25, 96.0),
        ("paged", PAGED, 0.5, 60.0), ("paged", PAGED, 1.0, 40.0),
        ("paged", PAGED, 1.5, 40.0),
        ("dense", DENSE, 6.0, 30.0), ("dense", DENSE, 12.0, 30.0))
SMOKE = (("paged", dict(PAGED, shared_prefix_tokens=24, max_new_tokens=4,
                        kv_block_budget=None), 4.0, 1.5),
         ("dense", DENSE, 8.0, 1.5))


def busy_shares(results, duration_s: float, dt: float = 0.01
                ) -> Dict[int, float]:
    """Share of the window's time in which k instances held at least one
    served sequence (admission to finish on the pool clock), over the
    times when at least one did: {k: share}. Sequences still resident
    when the window closed are not counted."""
    t = np.arange(0.0, duration_s, dt)
    held = {}
    for r in results:
        if r.rejected or r.admit_s < 0:
            continue
        m = held.setdefault((r.model, r.instance_id), np.zeros(t.shape, bool))
        m |= (t >= r.admit_s) & (t < r.finish_s)
    if not held:
        return {}
    k = np.sum(list(held.values()), axis=0)
    k = k[k > 0]
    return {int(n): float(np.mean(k == n)) for n in np.unique(k)}


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def summarize(pool, report, label: str, rps: float, duration_s: float,
              slo_ms: float) -> Dict:
    """One configuration's line: per model the issued, served and
    rejected requests, tokens, SLO attainment and latency percentiles;
    for the pool the busy-instance shares, the contention fit and the
    prefix cache's hit rate (0 with the cache off)."""
    models = {}
    every = []
    for m, row in report.items():
        res = pool.results(m)
        every += res
        served = [r for r in res if not r.rejected]
        lat = [r.latency_ms for r in served]
        tpot = [r.tpot_ms for r in served if r.tpot_ms >= 0]
        ttft = [r.ttft_ms for r in served if r.ttft_ms >= 0]
        unfinished = int(row["queued"]) + sum(
            i.n_resident for i in pool.live(m))
        tokens = int(row["generated_tokens"])
        models[m] = {
            "issued": len(res) + unfinished, "served": len(served),
            "rejected": int(row["rejected"]), "unfinished": unfinished,
            "served_tokens": tokens,
            "tokens_per_s": tokens / duration_s,
            "slo_attainment": row["slo_attainment"],
            "latency_ms_mean": row["mean_latency_ms"],
            "latency_ms_p50": _pct(lat, 50), "latency_ms_p90": _pct(lat, 90),
            "latency_ms_p99": _pct(lat, 99), "ttft_ms_p50": _pct(ttft, 50),
            "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p90": _pct(tpot, 90),
            "instances_used": len({r.instance_id for r in served}),
            "m_c_at_end": int(row["m_c"]),
        }
    shares = busy_shares(every, duration_s)
    t1, c = pool.contention()
    return {"pool": label, "rps": rps, "duration_s": duration_s,
            "slo_ms": slo_ms, "models": models,
            "busy_instance_shares": shares,
            "busy_instances_mean": float(sum(k * v for k, v in
                                             shares.items())),
            "instances_spawned": sum(len(v) for v in pool.instances.values())
            + len(pool.retired),
            "contention_t1_ms": t1, "contention_c": c,
            "prefix_cache": pool.prefix_cache,
            "prefix_hit_rate": pool.prefix_hit_rate(),
            "pool_steps": pool.n_steps}


def run(grid, device="cuda", reduced: bool = False, seed: int = 0,
        prefix_cache: bool = False) -> List[Dict]:
    """Serve every configuration of ``grid`` in turn through
    ``serve_pool``, at full width unless ``reduced`` and with the paged
    pool's prefix cache when ``prefix_cache``; returns their lines."""
    import torch

    from repro_torch.config import get_config, get_reduced_config
    from repro_torch.launch.engine_serve import serve_pool

    get = get_reduced_config if reduced else get_config
    lines = []
    for label, spec, rps, duration_s in grid:
        kw = {k: v for k, v in spec.items() if k != "models"}
        kept: list = []
        report = serve_pool(list(spec["models"]), duration_s=duration_s,
                            rps=rps, seed=seed,
                            cfgs={m: get(m) for m in spec["models"]},
                            prefix_cache=prefix_cache, device=device,
                            pool_out=kept, **kw)
        line = summarize(kept[0], report, label, rps, duration_s,
                         spec["slo_ms"])
        print("sweep " + json.dumps(line), flush=True)
        lines.append(line)
        del kept, report
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the configurations' lines here (JSONL)")
    ap.add_argument("--smoke", action="store_true",
                    help="two short configurations at reduced width")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve the paged configurations with the prefix "
                         "cache on")
    ap.add_argument("--rps", default=None,
                    help="comma-separated rates: keep only these "
                         "configurations of the grid")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {card.stdout.strip()}", flush=True)
    grid = SMOKE if args.smoke else GRID
    if args.rps:
        keep = {float(r) for r in args.rps.split(",")}
        grid = tuple(g for g in grid if g[2] in keep)
    lines = run(grid, device=args.device, reduced=args.smoke,
                prefix_cache=args.prefix_cache)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    for line in lines:
        for m, row in line["models"].items():
            print(f"{line['pool']} {line['rps']} rps {m}: issued "
                  f"{row['issued']}, served {row['served']}, rejected "
                  f"{row['rejected']}, attainment "
                  f"{row['slo_attainment']:.3f}, {row['served_tokens']} "
                  f"tokens ({row['tokens_per_s']:.2f}/s), latency p50 "
                  f"{row['latency_ms_p50']:.0f} p99 "
                  f"{row['latency_ms_p99']:.0f} ms, tpot p50 "
                  f"{row['tpot_ms_p50']:.1f} ms; busy instances "
                  f"{line['busy_instances_mean']:.2f}, prefix hit rate "
                  f"{line['prefix_hit_rate']:.3f}")


if __name__ == "__main__":
    main()
