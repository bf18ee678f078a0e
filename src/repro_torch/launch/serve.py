"""Serving launcher of the port: the BCEdge scheduler over the edge-serving
simulator (the default, as in ``repro.launch.serve``), or the real engine
(``--engine``) in round or continuous mode, or the multi-model instance
pool (``--models``), or push-mode HTTP serving (``--serve-http``). The
agents, the interference predictor and the engines run on the GPU unless
``--device cpu``; the simulator itself is numpy on the host. Round mode
ignores the continuous-engine flags, as the reference's does.

    PYTHONPATH=src python -m repro_torch.launch.serve --episodes 1 \
        --episode-ms 3000
    PYTHONPATH=src python -m repro_torch.launch.serve --exec-mode \
        continuous --decode-steps 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --exec-mode continuous --kv-layout paged --token-budget 64 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --exec-mode continuous --kv-layout paged --spec-k 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --models qwen3-0.6b --exec-mode continuous --kv-layout paged \
        --kv-block-budget 256 --preemption --kv-host-blocks 64 \
        --preempt-mode auto --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --serve-http --port 8907 --models qwen3-0.6b --max-instances 1 \
        --kv-layout paged
"""
from __future__ import annotations

import argparse

from repro_torch.serving.platforms import PLATFORMS


def simulate(cfg, episodes: int, episode_ms: float, guard: bool = True,
             device="cuda") -> None:
    """The reference CLI's simulator mode: one SAC agent (batch 256, lr
    5e-4) and, with ``guard``, the NN interference predictor, both on
    ``device``, trained online over ``episodes`` seeded episodes; prints
    one ``ep{i}:`` line per episode and the profiler's best (b, m_c) per
    model."""
    from repro_torch.core.interference import NNInterferencePredictor
    from repro_torch.core.sac import SACAgent, SACConfig
    from repro_torch.serving.bcedge import run_episode
    from repro_torch.serving.features import state_dim
    from repro_torch.serving.profiler import PerformanceProfiler
    from repro_torch.serving.simulator import EdgeServingEnv

    env0 = EdgeServingEnv(cfg, episode_ms=1.0)
    agent = SACAgent(state_dim(env0.models), cfg.n_actions,
                     SACConfig(batch_size=256, lr=5e-4), device=device)
    pred = NNInterferencePredictor(device=device) if guard else None
    profiler = PerformanceProfiler()
    for ep in range(episodes):
        env = EdgeServingEnv(cfg, episode_ms=episode_ms, seed=ep)
        res = run_episode(env, agent, pred, guard=guard)
        profiler.reset_env()
        profiler.poll(env)
        s = res.summary
        util = profiler.utilization()
        print(f"ep{ep}: utility={s['mean_utility']:.2f} "
              f"thr={s['throughput_rps']:.1f}rps "
              f"goodput={s['goodput_rps']:.1f}rps "
              f"viol={s['slo_violation_rate']:.1%} "
              f"lat={s['mean_latency_ms']:.0f}ms "
              f"busy={util['busy_frac']:.0%} "
              f"overhead={sum(res.overhead_ms)/max(len(res.overhead_ms),1):.2f}ms/decision")
    # profiler-informed per-model configurations (§IV-E)
    for m in env0.models:
        best = profiler.best_config(m, max_violation=0.2)
        if best:
            print(f"profile[{m}]: best (b, m_c) within 20% violations "
                  f"= {best}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="xavier_nx",
                    help=f"simulated edge platform, one of {sorted(PLATFORMS)}"
                         " (the paper's)")
    ap.add_argument("--rps", type=float, default=None,
                    help="Poisson arrival rate: per model in the simulator "
                         "(default 30, the paper's), overall for the engine "
                         "(default 12)")
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--episode-ms", type=float, default=20_000.0)
    ap.add_argument("--no-guard", action="store_true")
    ap.add_argument("--exec-mode", default="round",
                    choices=["round", "continuous"],
                    help="round = run-to-completion batches whose size the "
                         "SAC agent picks (the default, as in the JAX CLI); "
                         "continuous = iteration-level batching")
    ap.add_argument("--decode-steps", type=float, default=1.0,
                    help="simulator: mean decode iterations per request "
                         "(geometric); >1 makes the workload autoregressive")
    ap.add_argument("--prefill-tokens", type=float, default=0.0,
                    help="simulator: mean prompt tokens per request "
                         "(geometric; 0 = single-shot, no prefill modeling)")
    ap.add_argument("--engine", action="store_true",
                    help="serve a real model instead of the simulator")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="architecture id, served at its reduced width")
    ap.add_argument("--models", default=None,
                    help="comma-separated model ids: serve them "
                         "concurrently through the multi-model instance "
                         "pool with the PoolScheduler driving (b, m_c) "
                         "per model (requires --engine; continuous only)")
    ap.add_argument("--max-instances", type=int, default=4,
                    help="pool-wide cap on live engine instances (the "
                         "m_c budget shared by all --models)")
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
                         "tokens; engine: a fixed cap (the pool: its "
                         "scheduler axis too); simulator: adds an action "
                         "level. Default: uncapped")
    ap.add_argument("--preemption", action="store_true",
                    help="SLO-aware preemption: the pool evicts the "
                         "largest-slack resident when an urgent request "
                         "cannot be admitted; simulator: in continuous "
                         "sessions")
    ap.add_argument("--kv-host-blocks", type=int, default=0,
                    help="pinned host-memory KV block tier per paged "
                         "engine instance: preempted sequences can swap "
                         "their blocks there instead of recomputing, and "
                         "the prefix cache spills cold blocks there before "
                         "invalidating them. Default: 0 (no host tier)")
    ap.add_argument("--preempt-mode", default="auto",
                    choices=["auto", "recompute", "swap"],
                    help="the pool's eviction mode: recompute re-prefills "
                         "on resume; swap moves the KV to the host tier "
                         "(needs --kv-host-blocks); auto prices both with "
                         "the calibrated token-cost and swap-cost fits, "
                         "per victim")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="simulator: sessions skip shared prefixes an "
                         "earlier request already prefilled; engine and "
                         "pool (--kv-layout paged): full prompt blocks "
                         "are shared at refcount+1 (copy-on-write tails, "
                         "LRU reuse), on every model whose layers all "
                         "page")
    ap.add_argument("--shared-prefix-tokens", type=float, default=0.0,
                    help="templated workload: every prompt starts with one "
                         "of a small population of shared prefixes of this "
                         "many tokens (simulator, continuous engine and "
                         "pool; what --prefix-cache exploits). Default: 0 "
                         "(off)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding depth: up to k n-gram "
                         "drafts per slot, checked in one verify forward; "
                         "engine and pool: the cap, and the pool "
                         "scheduler's fourth axis; simulator: an added "
                         "action level. Continuous only. Default: 0 (off)")
    ap.add_argument("--serve-http", action="store_true",
                    help="push-mode HTTP serving: a background driver "
                         "steps the pool, an asyncio front-end streams "
                         "per-token ndjson events; requires --engine. "
                         "Runs until interrupted")
    ap.add_argument("--port", type=int, default=8808,
                    help="--serve-http listen port (0 = ephemeral)")
    ap.add_argument("--no-backpressure", action="store_true",
                    help="--serve-http: disable 429 admission "
                         "backpressure (accept everything)")
    ap.add_argument("--max-queue-depth", type=int, default=8,
                    help="--serve-http: queued requests tolerated per "
                         "model before arrivals that cannot start get "
                         "429 + Retry-After")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents, the predictor and "
                         "the engine; the default cuda fails without a "
                         "GPU, cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.models and not args.engine:
        ap.error("--models requires --engine (the simulator is already "
                 "multi-tenant over the paper's Table-IV models)")
    if args.prefix_cache and args.engine and args.kv_layout != "paged":
        ap.error("--prefix-cache on the engine needs --kv-layout paged "
                 "(sharing is block-granular)")
    if args.serve_http and not args.engine:
        ap.error("--serve-http requires --engine (the HTTP front-end "
                 "streams real engine tokens)")
    if args.kv_host_blocks and args.kv_layout != "paged":
        ap.error("--kv-host-blocks needs --kv-layout paged (the host "
                 "tier holds KV blocks)")
    if args.preempt_mode == "swap" and args.kv_host_blocks <= 0:
        ap.error("--preempt-mode swap needs --kv-host-blocks > 0 "
                 "(there is nowhere to swap to)")
    if args.platform not in PLATFORMS:
        ap.error(f"--platform {args.platform!r}: the port simulates the "
                 f"paper's edge platforms {sorted(PLATFORMS)} only; the "
                 "reference's tpu_v5e entry holds constants written for a "
                 "TPU, which the port does not carry over")

    if args.engine:
        from repro_torch.launch import engine_serve

        models = [m for m in (args.models or "").split(",") if m] or None
        engine_serve.main(exec_mode=args.exec_mode, arch=args.arch,
                          rps=12.0 if args.rps is None else args.rps,
                          models=models, max_instances=args.max_instances,
                          kv_layout=args.kv_layout,
                          kv_block_budget=args.kv_block_budget,
                          token_budget=args.token_budget,
                          preemption=args.preemption,
                          kv_host_blocks=max(0, args.kv_host_blocks),
                          preempt_mode=args.preempt_mode,
                          prefix_cache=args.prefix_cache,
                          shared_prefix_tokens=int(
                              args.shared_prefix_tokens),
                          spec_k=max(0, args.spec_k),
                          serve_http_port=args.port if args.serve_http
                          else None,
                          backpressure=not args.no_backpressure,
                          max_queue_depth=args.max_queue_depth,
                          device=args.device)
        return

    from repro_torch.config.base import ServingConfig

    cfg = ServingConfig(platform=args.platform,
                        arrival_rps=30.0 if args.rps is None else args.rps,
                        exec_mode=args.exec_mode,
                        decode_steps_mean=max(1.0, args.decode_steps),
                        prefill_tokens_mean=max(0.0, args.prefill_tokens),
                        token_budgets=(0,) if not args.token_budget
                        else (0, args.token_budget),
                        preemption=args.preemption,
                        shared_prefix_tokens=max(
                            0.0, args.shared_prefix_tokens),
                        prefix_cache=args.prefix_cache,
                        spec_depths=(0,) if args.spec_k <= 0
                        else (0, args.spec_k))
    simulate(cfg, args.episodes, args.episode_ms, guard=not args.no_guard,
             device=args.device)


if __name__ == "__main__":
    main()
