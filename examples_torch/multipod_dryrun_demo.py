"""Run one (arch x shape) case of the PyTorch port's dry-run on the
production mesh and print the roofline terms: the smallest multi-pod
dry-run demo. The step runs on ``meta`` tensors at the global shapes and
the terms are priced on the H100's data-sheet figures; nothing is
measured, and no GPU is needed.

Run:  python examples_torch/multipod_dryrun_demo.py \
          [--arch qwen3-0.6b] [--shape decode_32k] [--multi-pod]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.dryrun import run_case  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    res = run_case(args.arch, args.shape, args.multi_pod, out_dir=None)
    if res["status"] != "ok":
        raise SystemExit(res.get("error", res.get("reason")))
    r = res["roofline"]
    print(f"\narch={args.arch} shape={args.shape} mesh={res['mesh']}")
    print(f"bytes/device      : {res['bytes_per_device']/2**30:.2f} GiB")
    print(f"compute roofline  : {r['compute_s']*1e3:.2f} ms")
    print(f"memory roofline   : {r['memory_s']*1e3:.2f} ms")
    print(f"collective        : {r['collective_s']*1e3:.2f} ms")
    print(f"dominant term     : {res['dominant']}")
    print(f"useful FLOP ratio : {res['useful_flops_ratio']:.2f}")


if __name__ == "__main__":
    main()
