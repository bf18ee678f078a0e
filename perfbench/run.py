"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output and the compared
numbers with their limits as the last lines of standard error. Exits 2,
printing no result, when the cell is unknown, when no CUDA card (or
fewer than the cell's chips) is visible, or when the checkout holds no
program; exits 3 when a JAX module is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # every cache the run writes stays inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch
    from perfbench.harness import bench, cell, check
    try:
        c = cell.load(ROOT, args.workload)
    except (cell.CellError, KeyError) as e:
        bench.log(f"error: {e}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        bench.log(f"error: the cell needs {c.chips} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, count: "
                  f"{torch.cuda.device_count()}")
        return 2
    try:
        bench.import_program(ROOT)
    except ImportError as e:
        bench.log(f"error: no program in this checkout: {e}")
        return 2
    torch.cuda.set_device(0)
    result = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    bad = check.forbidden_modules()
    if bad:
        bench.log(f"error: modules loaded in this process: {bad}")
        return 3
    bench.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
