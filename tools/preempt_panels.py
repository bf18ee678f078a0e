#!/usr/bin/env python3
"""Chunked preemption's two panels (``repro_torch.figures.
fig_preemption_chunked``) one at a time at the fast profile's sizes, with
what the figure's rows do not show. The engine panel, uncapped and at the
figure's token budget, through the figure's own ``_run_engine_panel``
with its ``trace``: each iteration's host ms (until ``step`` returns)
and its ms until the device finishes (a synchronise after every step, so
the device cannot run ahead), its prefill chunks and whether a prompt
landed; the p50 and p99 of decode-only and prefill-carrying steps and the
slowest steps. Then the pool panel without and with preemption and the
three checks the figure makes there (preemption fired, attainment not
worse, preempted hogs token-identical).

    python3 tools/preempt_panels.py [--device cuda|cpu] [--steps 240]

Run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.figures import fig_preemption_chunked as fig  # noqa: E402


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def report_engine(label: str, rows: list) -> None:
    for col, name in ((4, "host"), (5, "to finish")):
        dec = [r[col] for r in rows if not r[1]]
        pre = [r[col] for r in rows if r[1]]
        print(f"{label} {name} ms: decode p50 {_pct(dec, 50):.3f} p99 "
              f"{_pct(dec, 99):.3f} ({len(dec)}); prefill p50 "
              f"{_pct(pre, 50):.3f} p99 {_pct(pre, 99):.3f} ({len(pre)}); "
              f"all p99 / decode p99 "
              f"{_pct(dec + pre, 99) / _pct(dec, 99):.2f}x")
    for r in sorted(rows, key=lambda r: -r[5])[:5]:
        print(f"{label} slow step {r[0]}: prefill {r[1]}, chunks {r[2]}, "
              f"landed {r[3]}, host {r[4]:.3f} ms, to finish {r[5]:.3f} ms")
    chunks = [r[2] for r in rows if r[1]]
    print(f"{label} chunks per prefill step: mean "
          f"{np.mean(chunks) if chunks else 0.0:.2f}, max "
          f"{max(chunks, default=0)}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=240)
    args = ap.parse_args()
    for budget in (None, fig.TOKEN_BUDGET):
        rows = []
        fig._run_engine_panel(budget, args.steps, args.device, trace=rows)
        report_engine(f"budget {budget or 0}", rows)
    rows = [fig._run_pool_panel(p, 200, 5, args.device)
            for p in (False, True)]
    for r in rows:
        print(f"pool: {r}")
    print(f"pool checks: preemption fired {rows[1]['n_preempted'] > 0}; "
          f"attainment {rows[1]['urgent_slo_attainment']:.2f} >= "
          f"{rows[0]['urgent_slo_attainment']:.2f}: "
          f"{rows[1]['urgent_slo_attainment'] >= rows[0]['urgent_slo_attainment']}"
          f"; hogs identical {rows[1]['hog_token_identical']}")


if __name__ == "__main__":
    main()
