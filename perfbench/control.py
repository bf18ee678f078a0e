"""The control of ``correct``: the cell's program and, at the same
positions of the same served sequences, the plain reference in a lower
precision (TF32 matrix products, and bfloat16), over several seeds in
one process. The benchmark's own runs do not run it.

    python3 perfbench/control.py --workload chatglm3-6b.batch \
        --seeds 1,2,3 --seconds 30 [--modes tf32,bf16]

Prints one JSON line a seed: the widest gap of the program's served
tokens and of each control's first choices (see ``harness/check.py``)
against the cell's limit. The limit holds where every program reading
is at or under it and every control reading above it.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.harness import bench  # noqa: E402


class Probe:
    """Keeps the program's own argmax and its logit at every served
    position: the last prefill piece of each prompt and every decode
    row, as device tensors read once the run is over."""

    def __init__(self, engine):
        self.steps = []  # (request ids, positions, values, indices)
        model = engine.model
        prefill, decode = model.prefill_chunk, model.decode_step

        def prefill_chunk(params, cache, batch):
            s = engine.slots[engine.prefilling_slots[0]]
            last = s.prefill_pos + batch["tokens"].shape[1] \
                == len(s.seq_tokens)
            out = prefill(params, cache, batch)
            if last:
                v, i = out[0][:, -1].max(-1)
                self.steps.append(([s.request_id], [len(s.seq_tokens) - 1],
                                   v, i))
            return out

        def decode_step(params, cache, batch):
            act = list(engine.decoding_slots)
            rids = [engine.slots[i].request_id for i in act]
            pos = [int(engine.pos[i]) for i in act]
            out = decode(params, cache, batch)
            v, i = out[0][act, -1].max(-1)
            self.steps.append((rids, pos, v, i))
            return out

        model.prefill_chunk, model.decode_step = prefill_chunk, decode_step
        self._rows = None

    def rows(self, rid):
        if self._rows is None:
            self._rows = {}
            for rids, pos, v, i in self.steps:
                for r, p, vv, ii in zip(rids, pos, v.tolist(), i.tolist()):
                    self._rows.setdefault(r, {})[p] = (ii, vv)
        return self._rows.get(rid, {})


def readings(root, workload, seeds, seconds, modes, device):
    """{seed: {"program": gap, <mode>: gap, "limit": limit, ...}}, with
    the program's largest logit error on its own argmax and the
    reference's smallest top-two margin over the compared positions."""
    out = {}
    for seed in seeds:
        r = bench.run_cell(root, workload, seed, seconds, False, device,
                           controls=modes, hook=Probe)
        c = r["checks"]
        out[seed] = {"program": c["logit_gap"]["value"],
                     "limit": c["logit_gap"]["limit"],
                     "tokens": c["tokens_compared_min"]["value"],
                     "program_logit_err": c["program_logit_err"]["value"],
                     "min_margin": c["min_margin"]["value"],
                     **{m: c[f"control_{m}_gap"]["value"] for m in modes}}
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--modes", default="tf32,bf16")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in a.seeds.split(",")]
    modes = tuple(a.modes.split(","))
    res = readings(ROOT, a.workload, seeds, a.seconds, modes,
                   torch.device("cuda", 0))
    for seed, row in res.items():
        print(json.dumps({"workload": a.workload, "seed": seed, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
