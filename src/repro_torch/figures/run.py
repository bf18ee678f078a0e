"""The figure runners' entry point: one module per paper figure.

Prints ``name,us_per_call,derived`` CSV rows and, per module, the
``# === name ===`` and ``# name took Xs`` lines. The default is the fast
profile (shorter episodes, fewer seeds); ``BENCH_FAST=0`` runs full
length; ``--smoke`` runs every module at toy scale (the check that keeps
the runners from rotting: numbers are meaningless, only the code paths
run). ``--only fig7`` runs the modules whose names contain ``fig7``.
``--device`` (default ``cuda``, which raises without a GPU) is where the
agents, the predictor and the engines run. Exits non-zero when any
module failed.

Run:  PYTHONPATH=src python -m repro_torch.figures.run [--smoke]
      [--only SUBSTR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import importlib
import os
import time
import traceback
from typing import List, Optional

from repro_torch.device import resolve_device

# the reference's order
MODULES = [
    "fig1_motivation",
    "fig7_utility",
    "fig8_9_timeline",
    "fig10_convergence",
    "fig11_12_scalability",
    "fig13_interference",
    "fig14_15_slo",
    "fig16_overhead",
    "fig_continuous_vs_round",
    "fig_multimodel_concurrency",
    "fig_paged_kv",
    "fig_preemption_chunked",
    "fig_prefix_cache",
    "fig_speculative",
    "fig_fused_kernels",
    "fig_sharded_engine",
    "fig_async_serving",
    "fig_kv_offload",
    "roofline_table",
]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="substring filter on module names")
    ap.add_argument("--smoke", action="store_true",
                    help="toy-scale run of every module (the rot check)")
    ap.add_argument("--device", default="cuda",
                    help="where agents, predictor and engines run")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.smoke:
        # each figure reads the profile when its main runs
        os.environ["BENCH_SMOKE"] = "1"
    failures = 0
    for name in MODULES:
        if args.only and args.only not in name:
            continue
        mod = importlib.import_module(f"repro_torch.figures.{name}")
        t0 = time.time()
        print(f"# === {name} ===", flush=True)
        try:
            mod.main(device=args.device)
        except Exception:  # noqa: BLE001  (report each module, run the rest)
            failures += 1
            print(f"{name},0.00,ERROR", flush=True)
            traceback.print_exc()
        print(f"# {name} took {time.time()-t0:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"{failures} figure module(s) failed")


if __name__ == "__main__":
    main()
