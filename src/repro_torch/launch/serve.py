"""Serving launcher of the port: the real engine in round or continuous
mode, or the multi-model instance pool (``--models``), on the GPU unless
``--device cpu`` (a subset of ``repro.launch.serve``, with its defaults:
round mode, dense KV).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --exec-mode continuous --kv-layout dense
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --exec-mode continuous --kv-layout paged --token-budget 64 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --models qwen3-0.6b --exec-mode continuous --kv-layout paged \
        --kv-block-budget 256
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", action="store_true",
                    help="serve a real model (the simulator is not ported "
                         "yet; required)")
    ap.add_argument("--exec-mode", default="round",
                    choices=["round", "continuous"],
                    help="round = run-to-completion batches whose size the "
                         "SAC agent picks (the default, as in the JAX CLI); "
                         "continuous = iteration-level batching")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="architecture id, served at its reduced width")
    ap.add_argument("--models", default=None,
                    help="comma-separated model ids: serve them "
                         "concurrently through the multi-model instance "
                         "pool with the PoolScheduler driving (b, m_c) "
                         "per model (continuous only)")
    ap.add_argument("--max-instances", type=int, default=4,
                    help="pool-wide cap on live engine instances (the "
                         "m_c budget shared by all --models)")
    ap.add_argument("--rps", type=float, default=12.0,
                    help="Poisson arrival rate, requests per second")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"],
                    help="KV cache layout of continuous mode (default "
                         "dense, as in the JAX CLI; round mode always uses "
                         "a dense per-round cache)")
    ap.add_argument("--kv-block-budget", type=int, default=None,
                    help="KV blocks in the engine's pool (default: the "
                         "dense-equivalent worst case)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-iteration cap on prefill-chunk + decode "
                         "tokens (default: uncapped)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default cuda fails without a "
                         "GPU, cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if not args.engine:
        ap.error("the port serves the real engine only: pass --engine (the "
                 "simulator is still to port, see ROADMAP.md)")

    from repro_torch.launch import engine_serve

    models = [m for m in (args.models or "").split(",") if m] or None
    engine_serve.main(exec_mode=args.exec_mode, arch=args.arch, rps=args.rps,
                      models=models, max_instances=args.max_instances,
                      kv_layout=args.kv_layout,
                      kv_block_budget=args.kv_block_budget,
                      token_budget=args.token_budget, device=args.device)


if __name__ == "__main__":
    main()
