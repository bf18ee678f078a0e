"""Find an open-loop cell's knee: the highest rate the engine sustains
without a growing backlog. One process, one set-up; each rate runs the
cell's schedule (preadmitted population, lead-in, window) and then
drains the engine.

    python3 perfbench/sweep.py --workload <open-loop cell> \
        --rates 1.5,2,2.5,3 --seconds 15 --seed 11 [--out sweep.jsonl]

Per rate it prints the time to first token of the window's first and
second halves (a backlog that grows shows as a second half far slower),
the queue left at the close, the mean decoding slots and step time.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import bench  # noqa: E402
from perfbench.harness.serve import Driver, Stamps  # noqa: E402
from perfbench.traffic.generator import Schedule  # noqa: E402


class SampledDriver(Driver):
    """A driver that notes the engine's queue and slots after each step."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.samples = []

    def step(self):
        super().step()
        e = self.engine
        self.samples.append((time.perf_counter(), len(e.decoding_slots),
                             len(e.waiting), e.n_iters))


def one_rate(cell, engine, seed, rate, seconds):
    stamps = Stamps()
    drv = SampledDriver(engine, stamps, None)
    drv.max_wait = 5.0
    sched = Schedule(cell.mix, seed, cell.config["vocab_size"])
    w = drv.run_open(sched, rate, seconds,
                     int(cell.settings.get("preadmit", 0)))
    rids = w.window_rids
    ttft = [(stamps.tokens[r][0] - stamps.due[r]) * 1e3 if r in stamps.tokens
            else float("inf") for r in rids]
    half = len(ttft) // 2
    inw = [s for s in drv.samples if w.start <= s[0] <= w.end]
    steps = inw[-1][3] - inw[0][3] if len(inw) > 1 else 0
    gaps = []
    for ts in stamps.tokens.values():
        gaps += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])
                 if w.start <= b <= w.end]
    done = sum(1 for rid, ts in stamps.tokens.items()
               if rid in stamps.results and w.start <= ts[-1] <= w.end)
    toks = sum(sum(1 for t in ts if w.start <= t <= w.end)
               for ts in stamps.tokens.values())
    row = {
        "rate": rate, "n_window": len(rids),
        "ttft_p50_first_half": float(np.median(ttft[:half])),
        "ttft_p50_second_half": float(np.median(ttft[half:])),
        "ttft_p90": float(np.percentile(ttft, 90)),
        "queue_at_close": min(inw, key=lambda s: abs(s[0] - w.end))[2]
        if inw else None,
        "decoding_mean": float(np.mean([s[1] for s in inw])) if inw else 0,
        "step_ms": 1e3 * seconds / steps if steps else None,
        "itl_p50_ms": float(np.median(gaps)) if gaps else None,
        "itl_p95_ms": float(np.percentile(gaps, 95)) if gaps else None,
        "tokens_s": toks / seconds,
        "finished_rps": done / seconds,
    }
    while engine.waiting or engine.active_slots:
        engine.step()
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cell, _, engine, _ = bench.setup(ROOT, a.workload, a.seed,
                                  torch.device("cuda", 0))
    rows = []
    for r in (float(x) for x in a.rates.split(",")):
        row = one_rate(cell, engine, a.seed, r, a.seconds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": a.workload, **row}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
