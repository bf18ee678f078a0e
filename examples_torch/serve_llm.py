"""End-to-end serving driver with the PyTorch port: the BCEdge scheduler
batching REAL model inference (reduced qwen3), wall-clock latencies and
all, on the GPU unless ``--device cpu``.

Thin wrapper around the importable entry point
``repro_torch.launch.engine_serve`` (also reachable as
``python -m repro_torch.launch.serve --engine [--exec-mode continuous]``).

Run:  python examples_torch/serve_llm.py [round|continuous] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import engine_serve  # noqa: E402


def main(exec_mode: str = "round", device="cuda"):
    engine_serve.main(exec_mode=exec_mode, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("exec_mode", nargs="?", default="round",
                    choices=("round", "continuous"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.exec_mode, args.device)
