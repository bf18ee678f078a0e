"""Real-engine serving driver (importable entry point for
``python -m repro_torch.launch.serve --engine``): the port of
``repro.launch.engine_serve``.

Requests with random token prompts arrive Poisson; latencies are
wall-clock and utilities are computed from them (Eq. 3).

* ``round`` — the SAC scheduler picks the batch size per round and the
  ``InferenceEngine`` runs each round to completion (paper §IV-D);
* ``continuous`` — arrivals are submitted into the
  ``ContinuousBatchingEngine`` as they land and join the running batch
  at iteration boundaries (dense or paged KV layout, optionally with the
  prefix cache over a templated workload and speculative decoding);
* ``serve_pool`` (``--models a,b``) — N concurrent engine instances
  across heterogeneous models behind the ``ModelInstancePool``, with the
  ``PoolScheduler`` driving the real (b, m_c) action per model
  (continuous only), optionally with SLO-aware preemption by recompute
  or into a host KV tier, and speculation as a fourth axis;
* ``serve_http`` (``--serve-http``) — push-mode serving: the pool steps
  on a background ``ServingDriver`` thread with the scheduler re-deciding
  on a wall-clock tick, and an asyncio ``ServingFrontend`` streams
  per-token ndjson events over HTTP until interrupted.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --engine
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --exec-mode continuous --kv-layout dense
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --exec-mode continuous --kv-layout paged --prefix-cache \
          --shared-prefix-tokens 500
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --exec-mode continuous --kv-layout paged --spec-k 4
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --models qwen3-0.6b,recurrentgemma-2b --exec-mode continuous \
          --kv-layout paged --kv-block-budget 64
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --models qwen3-0.6b --kv-layout paged --kv-block-budget 256 \
          --preemption --kv-host-blocks 64 --preempt-mode auto --spec-k 4
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --serve-http --port 8907 --models qwen3-0.6b --max-instances 1 \
          --kv-layout paged
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.config import get_reduced_config
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.interference import NNInterferencePredictor
from repro_torch.core.sac import SACAgent, SACConfig
from repro_torch.core.utility import utility
from repro_torch.serving.bcedge import PoolScheduler
from repro_torch.serving.engine import (SEQ_BUCKETS,
                                        ContinuousBatchingEngine,
                                        InferenceEngine, _bucket,
                                        supports_speculation)
from repro_torch.serving.runtime import ModelInstancePool

#: unique-tail length _shared_prefix_prompts appends to every prefix
#: (fixed: left-padding makes prefix sharing length-sensitive)
_PREFIX_TAIL = 8


def _serve_max_seq(shared_prefix_tokens: int, default: int = 128) -> int:
    """Cache length sized to the generated workload: a templated prompt
    (prefix + fixed tail) must fit its bucket and leave decode room; the
    historical default for untemplated traffic."""
    if not shared_prefix_tokens:
        return default
    bucket = _bucket(shared_prefix_tokens + _PREFIX_TAIL,
                     buckets=SEQ_BUCKETS)
    return max(default, bucket + 64)


def _shared_prefix_prompts(rng, vocab: int, shared_prefix_tokens: int,
                           population: int = 4):
    """Prompt factory for templated workloads: one of ``population``
    fixed shared prefixes plus a random unique tail of a FIXED length."""
    prefixes = [rng.integers(1, vocab, shared_prefix_tokens).astype(
        np.int32) for _ in range(population)]

    def draw():
        tail = rng.integers(1, vocab, _PREFIX_TAIL).astype(np.int32)
        return np.concatenate(
            [prefixes[int(rng.integers(population))], tail])
    return draw


def _report(served: int, violations: int, rounds: int, lat_sum: float,
            dur: float, slo_ms: float, label: str) -> None:
    print(f"[{label}] served {served} requests in {dur:.1f}s "
          f"({served/max(dur,1e-6):.1f} rps) over {rounds} rounds/iters")
    print(f"[{label}] mean latency {lat_sum/max(served,1):.0f}ms, "
          f"violations {violations/max(served,1):.1%} (SLO {slo_ms:.0f}ms)")


def serve_round(arch: str = "qwen3-0.6b", duration_s: float = 20.0,
                rps: float = 12.0, slo_ms: float = 1500.0,
                cfg: Optional[ModelConfig] = None,
                device="cuda") -> Dict[str, float]:
    """Round mode: the SAC agent picks b per round from the queue state,
    the engine runs the round to completion, and the round's utility is
    the agent's reward; the agent's first update comes once its replay
    holds a mini-batch of 32 rounds. ``cfg`` overrides the reduced
    registry config of ``arch`` (for example with the full-width one).
    Runs on ``device`` (default ``"cuda"``, which raises without a GPU).
    Returns served/violations/rounds, the number of SAC updates and the
    mean host milliseconds of ``act`` per round and of an ``update``."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}), round "
          f"mode, on {device}...")
    engine = InferenceEngine(cfg, max_seq=128, device=device)
    # first-use costs: cuBLAS handles, kernel builds
    engine.generate([np.arange(8, dtype=np.int32)], max_new_tokens=2)

    scfg = ServingConfig(batch_sizes=(1, 2, 4, 8), concurrency_levels=(1,))
    agent = SACAgent(4, scfg.n_actions,
                     SACConfig(batch_size=32, lr=1e-3), seed=0,
                     device=device)
    rng = np.random.default_rng(0)

    queue = []
    t0 = time.perf_counter()
    next_arrival = rng.exponential(1.0 / rps)
    served = violations = rounds = n_updates = 0
    lat_sum = act_s = update_s = 0.0
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        while next_arrival <= now:
            queue.append((next_arrival,
                          rng.integers(1, cfg.vocab_size,
                                       rng.integers(4, 24)).astype(np.int32)))
            next_arrival += rng.exponential(1.0 / rps)
        if not queue:
            time.sleep(0.002)
            continue
        oldest_age = now - queue[0][0]
        state = np.array([np.log1p(len(queue)), oldest_age,
                          np.log1p(served), 1.0], np.float32)
        ta = time.perf_counter()
        a = agent.act(state)
        act_s += time.perf_counter() - ta
        b, _ = scfg.action_to_pair(a)
        batch = queue[:b]
        queue = queue[b:]
        res = engine.generate([p for _, p in batch], max_new_tokens=4)
        done_t = time.perf_counter() - t0
        lats = [(done_t - arr) * 1000.0 for arr, _ in batch]
        viol = sum(1 for lat in lats if lat > slo_ms)
        served += len(batch)
        violations += viol
        lat_sum += sum(lats)
        rounds += 1
        u = utility(len(batch) / max(res.total_ms / 1000, 1e-3),
                    np.mean(lats) / 1000.0,
                    slo_ms / 1000.0 * len(batch), 1) - 2.0 * viol / len(batch)
        s2 = np.array([np.log1p(len(queue)), 0.0, np.log1p(served), 1.0],
                      np.float32)
        agent.observe(state, a, u, s2, False)
        tu = time.perf_counter()
        if agent.update():
            n_updates += 1
            update_s += time.perf_counter() - tu
    _report(served, violations, rounds, lat_sum,
            time.perf_counter() - t0, slo_ms, "round")
    stats = {"served": float(served), "violations": float(violations),
             "rounds": float(rounds), "sac_updates": float(n_updates),
             "sac_act_ms": act_s * 1e3 / max(rounds, 1),
             "sac_update_ms": update_s * 1e3 / max(n_updates, 1)}
    print(f"[round] stats: {stats}")
    return stats


def serve_continuous(arch: str = "qwen3-0.6b", duration_s: float = 20.0,
                     rps: float = 12.0, slo_ms: float = 1500.0,
                     max_slots: int = 4, kv_layout: str = "dense",
                     kv_block_budget: Optional[int] = None,
                     token_budget: Optional[int] = None,
                     prefix_cache: bool = False,
                     shared_prefix_tokens: int = 0, spec_k: int = 0,
                     cfg: Optional[ModelConfig] = None,
                     device="cuda") -> Dict[str, float]:
    """Continuous mode: arrivals are submitted into the slot engine as
    they land and join the running batch at iteration boundaries.
    ``kv_layout`` is ``"dense"`` (as the reference's default) or
    ``"paged"``; ``kv_block_budget`` caps the paged engine's block pool
    (default: the dense-equivalent worst case); ``token_budget`` caps
    per-iteration prefill+decode tokens. ``prefix_cache`` shares full
    prompt blocks between same-prefix sequences (paged, and a stack that
    pages every layer; else the engine's ``ValueError``);
    ``shared_prefix_tokens`` templates the prompts (one of four shared
    prefixes plus an 8-token tail) so the cache has something to hit,
    and sizes the cache to them. ``spec_k`` turns on self-speculative
    decoding (up to k n-gram drafts per slot, checked in one verify
    forward); a model whose cache cannot rewind serves with it off, as
    in the reference. ``cfg`` overrides the reduced registry config of
    ``arch`` (for example with the full-width one). Runs on ``device``
    (default ``"cuda"``, which raises without a GPU). Returns the
    engine's ``stats()`` plus ``served`` and ``violations``."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    if spec_k > 0 and not supports_speculation(cfg):
        print(f"{cfg.name}: cache not rewindable "
              f"(recurrent/windowed layers); serving with spec_k=0")
        spec_k = 0
    print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}), "
          f"{max_slots} slots, {kv_layout} KV, "
          f"token budget {token_budget or 'uncapped'}, "
          f"prefix cache {'on' if prefix_cache else 'off'}, "
          f"spec_k {spec_k or 'off'}, on {device}...")
    engine = ContinuousBatchingEngine(cfg, max_slots=max_slots,
                                      max_seq=_serve_max_seq(
                                          shared_prefix_tokens),
                                      kv_layout=kv_layout,
                                      kv_blocks=kv_block_budget,
                                      token_budget=token_budget,
                                      prefix_cache=prefix_cache,
                                      spec_k=spec_k, device=device)
    rng = np.random.default_rng(0)
    draw_prompt = _shared_prefix_prompts(
        rng, cfg.vocab_size, shared_prefix_tokens) \
        if shared_prefix_tokens else None

    t0 = time.perf_counter()
    next_arrival = rng.exponential(1.0 / rps)
    submit_t = {}
    served = violations = 0
    lat_sum = 0.0
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        while next_arrival <= now:
            prompt = draw_prompt() if draw_prompt is not None else \
                rng.integers(1, cfg.vocab_size,
                             rng.integers(4, 24)).astype(np.int32)
            rid = engine.submit(prompt, max_new_tokens=4)
            submit_t[rid] = next_arrival
            next_arrival += rng.exponential(1.0 / rps)
        if not engine.active_slots and not engine.waiting:
            time.sleep(0.002)
            continue
        for r in engine.step():
            done_t = time.perf_counter() - t0
            lat = (done_t - submit_t.pop(r.request_id, done_t)) * 1000.0
            served += 1
            lat_sum += lat
            violations += int(lat > slo_ms)
    _report(served, violations, engine.n_iters, lat_sum,
            time.perf_counter() - t0, slo_ms, "continuous")
    stats = engine.stats()
    print(f"[continuous] engine stats: {stats}")
    return {**stats, "served": float(served),
            "violations": float(violations)}


def serve_pool(models: Sequence[str] = ("qwen3-0.6b", "recurrentgemma-2b"),
               duration_s: float = 20.0, rps: float = 12.0,
               slo_ms: float = 2000.0, max_instances: int = 4,
               max_slots: int = 4, max_new_tokens: int = 4,
               control_ms: float = 500.0, seed: int = 0,
               kv_layout: str = "dense",
               kv_block_budget: Optional[int] = None,
               token_budget: Optional[int] = None,
               preemption: bool = False,
               kv_host_blocks: int = 0,
               preempt_mode: str = "auto",
               prefix_cache: bool = False,
               shared_prefix_tokens: int = 0, spec_k: int = 0,
               cfgs: Optional[Dict[str, ModelConfig]] = None,
               device="cuda",
               pool_out: Optional[list] = None
               ) -> Dict[str, Dict[str, float]]:
    """Multi-model pool serve: Poisson arrivals per model are routed by
    deadline into a ``ModelInstancePool`` of live engine instances while
    the ``PoolScheduler`` re-decides (b, m_c) per model once per Eq.-1
    slot (clamped to [control_ms, 2000] ms). ``kv_layout="paged"`` serves
    every instance from the block-pool KV layout under a shared
    ``kv_block_budget``; ``token_budget`` adds the per-iteration token cap
    as a third scheduler axis and ``preemption`` enables SLO-aware
    eviction. ``kv_host_blocks`` gives every paged instance a pinned host
    KV tier, so eviction can swap instead of recompute; ``preempt_mode``
    picks recompute, swap or auto (priced per victim). ``prefix_cache``
    shares full prompt blocks between same-prefix sequences on the models
    that page every layer (the others serve without it), with the
    router's prefix affinity; pair it with ``shared_prefix_tokens``,
    which templates the prompts (a shared prefix plus an 8-token tail)
    and sizes the cache to them. ``spec_k`` caps self-speculative
    decoding and adds the depth as the scheduler's fourth axis (k in {0,
    k/2, k}; models whose cache can rewind). ``cfgs`` (model -> config)
    overrides the reduced registry configs (for example with the
    full-width ones). Runs on ``device`` (default ``"cuda"``, which
    raises without a GPU).
    ``pool_out``, a list, receives the pool, for callers that read its
    per-request results. Returns the pool's
    per-model report."""
    cfgs = dict(cfgs) if cfgs is not None else {
        m: get_reduced_config(m) for m in models}
    for m, cfg in cfgs.items():
        print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}) "
              f"on {device}...")
    pool = ModelInstancePool(cfgs, max_instances=max_instances,
                             max_slots=max_slots,
                             max_seq=_serve_max_seq(shared_prefix_tokens),
                             seed=seed, strict_admission=True,
                             predictor=NNInterferencePredictor(
                                 seed=seed, device=device),
                             kv_layout=kv_layout,
                             kv_block_budget=kv_block_budget,
                             preemption=preemption,
                             kv_host_blocks=max(0, kv_host_blocks),
                             preempt_mode=preempt_mode,
                             prefix_cache=prefix_cache, spec_k=spec_k,
                             device=device)
    if pool_out is not None:
        pool_out.append(pool)
    per_model_mc = max(1, max_instances // max(1, len(cfgs)))
    scfg = ServingConfig(
        batch_sizes=tuple(b for b in (1, 2, 4, 8) if b <= max_slots),
        concurrency_levels=tuple(range(1, per_model_mc + 1)),
        token_budgets=(0,) if not token_budget
        else (0, 2 * token_budget, token_budget),
        spec_depths=(0,) if not spec_k
        else tuple(sorted({0, max(1, spec_k // 2), spec_k})))
    sched = PoolScheduler(pool, scfg, slo_ms={m: slo_ms for m in cfgs},
                          decode_steps_mean=max_new_tokens, seed=seed)
    sched.control()  # initial allocation (spawns the first instances)

    # first-use costs (kernel libraries, library handles) before traffic,
    # then zero the metrics
    for m in cfgs:
        if pool.m_c(m) == 0:
            pool.scale_to(m, 1)
    pool.warmup(seed=seed)

    rng = np.random.default_rng(seed)
    draw_prompt = {m: _shared_prefix_prompts(rng, cfg.vocab_size,
                                             shared_prefix_tokens)
                   for m, cfg in cfgs.items()} if shared_prefix_tokens \
        else None
    per_rps = rps / max(1, len(cfgs))
    next_arrival = {m: rng.exponential(1.0 / per_rps) for m in cfgs}
    next_control = control_ms / 1000.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        for m, cfg in cfgs.items():
            while next_arrival[m] <= now:
                prompt = draw_prompt[m]() if draw_prompt is not None \
                    else rng.integers(1, cfg.vocab_size,
                                      rng.integers(4, 24)).astype(np.int32)
                pool.submit(m, prompt, slo_ms=slo_ms,
                            max_new_tokens=max_new_tokens)
                next_arrival[m] += rng.exponential(1.0 / per_rps)
        if now >= next_control:
            applied = sched.control()
            slot = max(pool.slot_ms(m) for m in cfgs)
            next_control = now + float(
                np.clip(slot, control_ms, 2000.0)) / 1000.0
            print(f"[pool t={now:5.1f}s] (b, m_c)={applied} "
                  f"live={pool.total_live()}")
        if not any(i.n_resident for i in pool.live()) \
                and not any(pool.queues.values()):
            time.sleep(0.002)
            continue
        sched.record(pool.step())

    report = pool.report()
    dur = time.perf_counter() - t0
    for m, row in report.items():
        print(f"[pool:{m}] served {row['served']:.0f} "
              f"({row['served']/max(dur,1e-6):.1f} rps), "
              f"SLO attainment {row['slo_attainment']:.1%}, "
              f"mean latency {row['mean_latency_ms']:.0f}ms, "
              f"utility {row['mean_utility']:.2f}, m_c={row['m_c']:.0f}, "
              f"preempted {row['preempted']:.0f}")
    print(f"[pool] stats: {pool.stats()}")
    print(f"[pool] guard interventions: {sched.guard_interventions}")
    return report


def serve_http(models: Sequence[str] = ("qwen3-0.6b",),
               host: str = "127.0.0.1", port: int = 8808,
               slo_ms: float = 2000.0, max_instances: int = 4,
               max_slots: int = 4, seed: int = 0,
               kv_layout: str = "paged",
               kv_block_budget: Optional[int] = None,
               backpressure: bool = True, max_queue_depth: int = 8,
               control_ms: float = 500.0,
               ready: Optional[Callable[[int], None]] = None,
               configs: Optional[Dict[str, ModelConfig]] = None,
               device="cuda") -> None:
    """Push-mode HTTP serving: the pool runs on a background
    :class:`~repro_torch.serving.driver.ServingDriver` thread with the
    ``PoolScheduler`` re-deciding (b, m_c) on a wall-clock tick, and an
    asyncio :class:`~repro_torch.launch.server.ServingFrontend` streams
    per-token events over HTTP until interrupted (or until the task that
    runs it is cancelled). ``ready(port)`` fires on the event loop once
    the socket is bound (``port=0`` picks an ephemeral port).
    ``configs`` overrides the registry lookup with explicit
    ``ModelConfig`` objects (a tiny model, or a full-width one). Runs on
    ``device`` (default ``"cuda"``, which raises without a GPU)."""
    import asyncio

    from repro_torch.launch.server import ServingFrontend
    from repro_torch.serving.driver import ServingDriver

    cfgs = configs or {m: get_reduced_config(m) for m in models}
    for m, cfg in cfgs.items():
        print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}) "
              f"on {device}...")
    pool = ModelInstancePool(cfgs, max_instances=max_instances,
                             max_slots=max_slots, max_seq=128, seed=seed,
                             kv_layout=kv_layout,
                             kv_block_budget=kv_block_budget, device=device)
    per_model_mc = max(1, max_instances // max(1, len(cfgs)))
    scfg = ServingConfig(
        batch_sizes=tuple(b for b in (1, 2, 4, 8) if b <= max_slots),
        concurrency_levels=tuple(range(1, per_model_mc + 1)))
    sched = PoolScheduler(pool, scfg, slo_ms={m: slo_ms for m in cfgs},
                          seed=seed)
    sched.control()
    for m in cfgs:
        if pool.m_c(m) == 0:
            pool.scale_to(m, 1)
    pool.warmup(seed=seed)

    async def _run() -> None:
        with ServingDriver(pool, on_tick=sched.tick,
                           tick_interval_s=control_ms / 1000.0) as driver:
            fe = ServingFrontend(driver, host=host, port=port,
                                 backpressure=backpressure,
                                 max_queue_depth=max_queue_depth,
                                 default_slo_ms=slo_ms)
            await fe.start()
            print(f"[http] serving {sorted(cfgs)} on "
                  f"http://{host}:{fe.port} "
                  f"(backpressure {'on' if backpressure else 'off'})")
            if ready is not None:
                ready(fe.port)
            try:
                await fe.serve_forever()
            except asyncio.CancelledError:
                pass
            finally:
                await fe.stop()
                print(f"[http] stopped; stats: {driver.stats()}")

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        print("[http] interrupted")


def main(exec_mode: str = "round", arch: str = "qwen3-0.6b",
         duration_s: float = 20.0, rps: float = 12.0,
         slo_ms: float = 1500.0, models: Optional[Sequence[str]] = None,
         max_instances: int = 4, kv_layout: str = "dense",
         kv_block_budget: Optional[int] = None,
         token_budget: Optional[int] = None,
         preemption: bool = False, kv_host_blocks: int = 0,
         preempt_mode: str = "auto", prefix_cache: bool = False,
         shared_prefix_tokens: int = 0, spec_k: int = 0,
         serve_http_port: Optional[int] = None,
         backpressure: bool = True, max_queue_depth: int = 8,
         device="cuda") -> None:
    """Dispatch as the reference's ``main`` does: HTTP serving, the pool,
    continuous mode or round mode. Round mode prints that the
    continuous-engine features are ignored and serves."""
    if serve_http_port is not None:
        serve_http(models or [arch], port=serve_http_port, slo_ms=slo_ms,
                   max_instances=max_instances,
                   kv_layout=kv_layout if kv_layout else "paged",
                   kv_block_budget=kv_block_budget,
                   backpressure=backpressure,
                   max_queue_depth=max_queue_depth, device=device)
    elif models:
        if exec_mode != "continuous":
            print("multi-model pool serving is continuous-only; "
                  "running with --exec-mode continuous")
        serve_pool(models, duration_s, rps, slo_ms,
                   max_instances=max_instances, kv_layout=kv_layout,
                   kv_block_budget=kv_block_budget,
                   token_budget=token_budget, preemption=preemption,
                   kv_host_blocks=kv_host_blocks, preempt_mode=preempt_mode,
                   prefix_cache=prefix_cache,
                   shared_prefix_tokens=int(shared_prefix_tokens),
                   spec_k=spec_k, device=device)
    elif exec_mode == "continuous":
        serve_continuous(arch, duration_s, rps, slo_ms, kv_layout=kv_layout,
                         kv_block_budget=kv_block_budget,
                         token_budget=token_budget,
                         prefix_cache=prefix_cache,
                         shared_prefix_tokens=int(shared_prefix_tokens),
                         spec_k=spec_k, device=device)
    else:
        if kv_layout != "dense":
            print("round mode always uses the dense per-round cache; "
                  "--kv-layout applies to continuous/pool serving")
        if token_budget or preemption or prefix_cache or spec_k \
                or kv_host_blocks:
            print("chunked prefill / preemption / prefix caching / "
                  "speculation / KV offload are continuous-engine "
                  "features; ignored in round mode")
        serve_round(arch, duration_s, rps, slo_ms, device=device)
