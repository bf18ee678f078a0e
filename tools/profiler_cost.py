#!/usr/bin/env python3
"""What torch.profiler costs ``chip_smoke.py``'s profiles, with host and
device activity recorded and with device activity alone:

    python3 tools/profiler_cost.py

On the drains' paged engine (full-width qwen3-0.6b, 8 slots, max_seq 640,
budget 512) at tp = 1 and at tp = 2 (both shards on the one card), twice
each in turns: a prefill step of 8 prompts of 30..400 tokens and three
decode-only steps (``phase_profile``'s), each under both settings. Prints
per profile the wall seconds of the profiled run, the seconds of reading
its events, the device kernels recorded and their busy ms, with the card's
name and power limit. Needs one CUDA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _profile(torch, fn, activities):
    from torch.profiler import profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    n, busy = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            busy += e.time_range.elapsed_us() / 1e3
    return t1 - t0, time.perf_counter() - t1, n, busy


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profiler_cost: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ContinuousBatchingEngine

    device = torch.device("cuda", 0)
    smi = cs.phase_env(torch)
    cs.phase_build()
    cfg = get_config(cs.FULL)
    params = init_params(cfg, seed=0, device=device)
    settings = (("host+device", [ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]),
                ("device", [ProfilerActivity.CUDA]))
    for mesh in (None, make_tp_mesh(2, devices=[device] * 2)):
        tp = 1 if mesh is None else 2
        eng = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                       kv_layout="paged", token_budget=512,
                                       device=device, params=params,
                                       mesh=mesh)
        rng = np.random.default_rng(0)
        eng.run([rng.integers(1, cfg.vocab_size, 9).astype(np.int32)],
                max_new_tokens=2)

        def three():
            for _ in range(3):
                eng.step()
        for tag, acts in settings * 2:
            for n in (100, 200, 300, 400, 30, 60, 90, 120):
                eng.submit(rng.integers(1, cfg.vocab_size, n).astype(
                    np.int32), max_new_tokens=8)
            for what, fn in (("prefill step", eng.step),
                             ("3 decode-only steps", three)):
                if fn is three:
                    while eng.prefill_backlog_tokens:
                        eng.step()
                run_s, read_s, n_k, busy = _profile(torch, fn, acts)
                print(f"tp {tp} {tag:11s} {what}: profiled run {run_s:.3f} "
                      f"s, events read {read_s:.3f} s, {n_k} device kernels,"
                      f" busy {busy:.3f} ms [{smi}]", flush=True)
            while eng.waiting or eng.active_slots:
                eng.step()
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
