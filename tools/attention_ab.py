#!/usr/bin/env python3
"""The five attention kernels and the two recurrent scans (or one
model's dense drain, or its round and prefill chunk) of two checkouts on
one GPU, in turns: ``--base`` (for example a ``git archive`` of the
parent commit unpacked into ``build/``), this checkout, this checkout,
``--base``, repeated to ``--turns`` turns in all.

    python3 tools/attention_ab.py --base build/parent
    python3 tools/attention_ab.py --base build/parent \
        --drain recurrentgemma-2b --turns 8
    python3 tools/attention_ab.py --base build/parent --prefill rwkv6-3b

Each turn runs in a process of its own (the two checkouts'
``repro_torch`` packages share a name) and uses only that checkout's
code: its kernels, built from its sources, and its ``chip_smoke.py``,
whose inputs (``_paged_job``, ``_splitk_job``, ``_flash_job``,
``_decode_job``, and for the scans ``_rglru_job`` and ``_rwkv_job`` at
``(1|8, 512, 2560)`` and ``(1|8, 512, 40, 64)``) and timers it calls
(``_time_ms``, the CUDA-event ms per call over 50 calls; ``_device_ms``,
the profiler's device ms per call, or, in a checkout without it, the same
sum over ``_profiled``'s kernels). With ``--drain ARCH`` a turn serves
that model at full width through the dense continuous engine with the
checkout's ``phase_e2e`` (16 seeded requests, drained, then profiled) and
reads its decode-only iteration p50 and p99 and its device busy per
decode-only iteration. With ``--prefill ARCH`` a turn builds that model at
full width (seed 0) and profiles, three times each, one round of
``InferenceEngine.generate`` (b = 8, prompts of 30..400 tokens, 4 new
tokens: the round ``chip_smoke.py`` profiles) and the step of the dense
continuous engine that prefills one 512-token prompt as one chunk
(token budget 512); it reads each one's device busy and the share of it
in the recurrent scan kernels.

Prints one line per shape: each number's mean per checkout, every turn's
value, and the change's ratio to the base, with the card's name and
power limit; the last line is a JSON object of the same. Needs one CUDA
GPU; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: recurrentgemma-2b's local heads (chip_smoke.RG_HEADS)
RG = {"H": 10, "KV": 1, "hd": 256}
#: (kernel, chip_smoke job, positional args, keyword args): the attention
#: shapes of chip_smoke's timing phase
JOBS = (
    ("paged_decode_attention", "_paged_job", ("splitk_case", {"B": 32,
                                                              "nb": 8}), {}),
    ("paged_decode_attention_splitk", "_splitk_job", (4, 36, 4), {}),
    ("paged_decode_attention_splitk", "_splitk_job", (8, 40, 2), {}),
    ("paged_decode_attention_splitk", "_splitk_job", (4, 256, 4), {}),
    ("paged_prefill_attention", "_paged_job",
     ("paged_prefill_case", {"T": 512, "pos": 0}), {}),
    ("paged_prefill_attention", "_paged_job",
     ("paged_prefill_case", {"T": 128, "pos": 200}), {}),
    ("paged_prefill_attention", "_paged_job",
     ("paged_prefill_case", {"T": 16, "pos": 8}), {}),
    ("flash_attention", "_flash_job", (8, 512, 512, True, None), {}),
    ("flash_attention", "_flash_job", (1, 100, 100, True, None), {}),
    ("flash_attention", "_flash_job", (8, 512, 512, True, 64), {}),
    ("flash_attention", "_flash_job", (8, 512, 512, True, 2048), RG),
    ("flash_attention", "_flash_job", (2, 512, 512, True, 64), RG),
    ("decode_attention", "_decode_job", (544, "round"), {}),
    ("decode_attention", "_decode_job", (640, "linear"), {}),
    ("decode_attention", "_decode_job", (640, "ring"), {}),
    ("decode_attention", "_decode_job", (2048, "round"),
     dict(RG, front=528)),
    ("decode_attention", "_decode_job", (640, "linear"), RG),
    ("decode_attention", "_decode_job", (2048, "ring"), dict(RG,
                                                              window=2048)),
    ("rglru_scan", "_rglru_job", (1, 512, 2560), {}),
    ("rglru_scan", "_rglru_job", (8, 512, 2560), {}),
    ("rwkv6_scan", "_rwkv_job", (1, 512, 40, 64), {}),
    ("rwkv6_scan", "_rwkv_job", (8, 512, 40, 64), {}),
)
#: profiler name fragments of the recurrent scan kernels
SCAN_KERNELS = ("rglru_kernel", "rwkv6_kernel")


def _device_ms(cs, torch, fn, n, calls=20):
    if hasattr(cs, "_device_ms"):
        return cs._device_ms(torch, fn, n, calls)[0]
    counts = {}
    _, _, _, names = cs._profiled(
        torch, lambda: [fn(i % n) for i in range(calls)], counts)
    return sum(t / counts[k] * max(1, round(counts[k] / calls))
               for k, t in names.items())


def _prefill_rows(cs, torch, device, arch):
    """The round and the 512-token chunk of ``arch`` (``--prefill``): one
    JSON line each, device busy and scan ms, means over three profiles."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            InferenceEngine)

    cfg = get_config(arch)
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(7)
    V = cfg.vocab_size
    prompts = [rng.integers(1, V, n).astype(np.int32)
               for n in (100, 200, 300, 400, 30, 60, 90, 120)]
    eng = InferenceEngine(cfg, device=device, params=params)
    eng.generate(prompts, max_new_tokens=4)  # warm-up and builds
    cont = ContinuousBatchingEngine(cfg, max_slots=8, max_seq=640,
                                    kv_layout="dense", token_budget=512,
                                    device=device, params=params)
    chunk = rng.integers(1, V, 512).astype(np.int32)

    def one_chunk():
        cont.submit(chunk, max_new_tokens=2)
        return cont.step

    cont.run([chunk], max_new_tokens=2)  # warm-up
    jobs = (("round b=8 +4 tokens",
             lambda: (lambda: eng.generate(prompts, max_new_tokens=4))),
            ("one 512-token chunk step", one_chunk))
    for i, (what, make) in enumerate(jobs):
        busy, scan = [], []
        for _ in range(3):
            fn = make()
            _, b, _, names = cs._profiled(torch, fn)
            busy.append(b)
            scan.append(sum(ms for n, ms in names.items()
                            if any(f in n for f in SCAN_KERNELS)))
            while cont.waiting or cont.active_slots:
                cont.step()
        print(json.dumps({"job": i, "name": arch, "what": what,
                          "device_ms": sum(busy) / 3,
                          "scan_ms": sum(scan) / 3}), flush=True)


def worker(root: Path, drain, prefill=None) -> None:
    """One turn with ``root``'s code; one JSON line per shape."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == root.resolve(), cs.__file__
    device = torch.device("cuda", 0)
    if prefill:
        _prefill_rows(cs, torch, device, prefill)
        return
    if drain:
        import contextlib
        import io
        import re

        from repro_torch.config import get_config
        from repro_torch.models.transformer import init_params

        cfg = get_config(drain)
        params = init_params(cfg, seed=0, device=device)
        logged = io.StringIO()
        with contextlib.redirect_stdout(logged):
            _, res = cs.phase_e2e(torch, device, cfg, params, "", "dense")
        busy = re.search(r"decode-only device busy ([0-9.]+) ms",
                         logged.getvalue())
        print(json.dumps({"job": 0, "name": drain, "what": "dense drain",
                          "p50": res["p50"], "p99": res["p99"],
                          "device_ms": float(busy.group(1))}), flush=True)
        return
    from repro_torch.kernels import _build

    _build.build()
    wrappers = cs._wrappers()
    for i, (name, job, args, kw) in enumerate(JOBS):
        if job == "_paged_job":
            args = (getattr(cs, args[0]), args[1])
        k_args, _, _, _, what, *_ = getattr(cs, job)(torch, device, *args,
                                                     **kw)
        kern = wrappers[name][0]

        def fn(j):
            return kern(**k_args[j])
        n = len(k_args)
        print(json.dumps({"job": i, "name": name, "what": what,
                          "event_ms": cs._time_ms(torch, fn, n),
                          "device_ms": _device_ms(cs, torch, fn, n)}),
              flush=True)
        del k_args
        torch.cuda.empty_cache()


def turn(root: Path, drain=None, prefill=None) -> dict:
    cmd = [sys.executable, __file__, "--worker", str(root)]
    cmd += ["--drain", drain] if drain else []
    cmd += ["--prefill", prefill] if prefill else []
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"attention_ab: turn at {root} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {r["job"]: r for r in rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--drain", metavar="ARCH",
                    help="compare the dense drain of this model instead")
    ap.add_argument("--prefill", metavar="ARCH",
                    help="compare this model's b = 8 round and 512-token "
                    "prefill chunk instead")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns in all, a multiple of 4 (default 4)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.drain, args.prefill)
        return 0
    if args.base is None or args.turns < 4 or args.turns % 4:
        ap.error("--base is required, and --turns a multiple of 4")
    import torch

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = args.base.resolve()
    runs = {"base": [], "change": []}
    for _ in range(args.turns // 4):
        for who, root in (("base", base), ("change", ROOT),
                          ("change", ROOT), ("base", base)):
            runs[who].append(turn(root, args.drain, args.prefill))
    keys = ("device_ms", "p50", "p99") if args.drain \
        else ("device_ms", "scan_ms") if args.prefill \
        else ("device_ms", "event_ms")
    out = []
    for i in sorted(runs["change"][0]):
        first = runs["change"][0][i]
        row = {"name": first["name"], "what": first["what"]}
        text = []
        for key in keys:
            b = [r[i][key] for r in runs["base"]]
            c = [r[i][key] for r in runs["change"]]
            row[key] = {"base": sum(b) / len(b), "change": sum(c) / len(c),
                        "base_runs": b, "change_runs": c,
                        "ratio": sum(c) / sum(b)}
            text.append(f"{key} base {sum(b) / len(b):.4f} (runs "
                        f"{', '.join(f'{x:.4f}' for x in b)}), change "
                        f"{sum(c) / len(c):.4f} (runs "
                        f"{', '.join(f'{x:.4f}' for x in c)}), change / "
                        f"base {sum(c) / sum(b):.3f}")
        out.append(row)
        print(f"ab {row['name']} {row['what']}: {'; '.join(text)} [{smi}]",
              flush=True)
    print(json.dumps({"device": smi, "rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
