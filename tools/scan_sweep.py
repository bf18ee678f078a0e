#!/usr/bin/env python3
"""The two recurrent scan kernels on one GPU at every launch plan their
entry points take around the ones ``rwkv6_plan`` and ``rglru_plan``
choose, at the shapes ``chip_smoke.py`` times:

    python3 tools/scan_sweep.py

``rwkv6_scan`` at (B, S, H, hd) = (1|8, 512, 40, 64) over column groups
of 8, 16, 32 and 64 (those within the kernel's thread and shared-memory
limits); ``rglru_scan`` at (1|8, 512, 2560) over 1, 2, 4, 7, 10 and 16
time chunks. Each plan is launched through the kernel's C entry point on
``chip_smoke.py``'s inputs (``_rwkv_job``, ``_rglru_job``), checked
against the plain version, and timed by ``chip_smoke._device_ms`` (the
profiler's device ms per call). Prints one line per plan, the chosen one
marked, with the card's name and power limit; the last line is a JSON
object of the same. Needs one CUDA GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("scan_sweep: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import rglru_plan
    from repro_torch.kernels.rwkv6_scan import (COLS, MAX_SMEM, MAX_THREADS,
                                                rwkv6_plan, rwkv6_smem)

    smi = cs.phase_env(torch)
    device = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    plain = cs._wrappers()
    rows = []

    def record(name, shape, plan, chosen, fn, args, want):
        got = fn(0)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms, _ = cs._device_ms(torch, fn, len(args))
        rows.append({"kernel": name, "shape": shape, "plan": plan,
                     "chosen": chosen, "device_ms": ms, "max_abs_err": err})
        print(f"sweep {name} {shape} plan {plan}{' (chosen)' if chosen else ''}"
              f": device {ms:.4f} ms, max abs err vs plain {err:.2e} [{smi}]",
              flush=True)

    rwkv = _build.load("rwkv6_scan")
    for B in (1, 8):
        B, S, H, hd = shape = (B, 512, 40, 64)
        args, _, _, _, _ = cs._rwkv_job(torch, device, *shape)
        want = plain["rwkv6_scan"][1](**args[0])
        chosen = rwkv6_plan(B, H, hd, n_sm)
        R, rows_per = chosen[1], chosen[2]
        for jc in (8, 16, 32, 64):
            if jc // COLS * R > MAX_THREADS or rwkv6_smem(jc, R) > MAX_SMEM:
                continue

            def call(i, jc=jc):
                c = args[i]
                out = torch.empty_like(c["r"])
                s_final = torch.empty_like(c["state"])
                rc = rwkv(*(c[n].data_ptr() for n in "rkvwu"),
                          c["state"].data_ptr(), out.data_ptr(),
                          s_final.data_ptr(), B, S, H, hd, jc, R, rows_per,
                          device.index, stream)
                if rc:
                    raise RuntimeError(f"rwkv6_scan: CUDA error {rc}")
                return out, s_final
            record("rwkv6_scan", shape, (jc, R, rows_per),
                   (jc, R, rows_per) == chosen, call, args, want)

    rglru = _build.load("rglru_scan")
    for B in (1, 8):
        B, S, W = shape = (B, 512, 2560)
        args, _, _, _, _ = cs._rglru_job(torch, device, *shape)
        want = plain["rglru_scan"][1](**args[0])
        chosen = rglru_plan(B, S, W, n_sm)
        for C in (1, 2, 4, 7, 10, 16):
            L = -(-S // C)
            C = -(-S // L)

            def call(i, C=C, L=L):
                c = args[i]
                hs = torch.empty_like(c["a"])
                h_final = torch.empty_like(c["h0"])
                summ = torch.empty((2, B, C, W), device=device) \
                    if C > 1 else None
                rc = rglru(c["a"].data_ptr(), c["x"].data_ptr(),
                           c["h0"].data_ptr(), hs.data_ptr(),
                           h_final.data_ptr(),
                           summ.data_ptr() if summ is not None else None,
                           B, S, W, chosen[0], C, L, device.index, stream)
                if rc:
                    raise RuntimeError(f"rglru_scan: CUDA error {rc}")
                return hs, h_final
            record("rglru_scan", shape, (chosen[0], C, L),
                   (chosen[0], C, L) == chosen, call, args, want)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
