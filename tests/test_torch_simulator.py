"""The port's edge-serving simulator (``repro_torch.serving.simulator``) and
what it stands on, on the CPU: the mirror of tests/test_simulator.py and
of the simulator tests of tests/test_continuous.py and
tests/test_preemption.py, run on the port, then the port against the JAX
package.

The simulator is numpy in both packages, so the comparison is exact, with
no tolerance: under the same config, seed and action sequence the port's
``EdgeServingEnv`` must give the reference's states, rewards, ``done``,
``info`` (transitions and rounds), every ``CompletedRound`` field and
``summarize()``, over five configs (round; continuous; chunked prefill
under token budgets with preemption; shared prefixes with the prefix
cache; speculation) at two seeds. A difference means an RNG draw was
consumed out of order or a float expression was reassociated in a copy.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.config.base import ServingConfig as JaxServingConfig
from repro.configs.paper_edge_models import EDGE_MODELS as JAX_EDGE_MODELS
from repro.serving import features as jax_features
from repro.serving import latency_model as jax_lm
from repro.serving.platforms import PLATFORMS as JAX_PLATFORMS
from repro.serving.simulator import EdgeServingEnv as JaxEnv
from repro.serving.workload import PoissonWorkload as JaxWorkload
from repro_torch.config.base import ServingConfig
from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.core.baselines import FixedScheduler
from repro_torch.serving import features
from repro_torch.serving import latency_model as lm
from repro_torch.serving.bcedge import run_episode
from repro_torch.serving.platforms import PLATFORMS
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.simulator import EdgeServingEnv, _Session
from repro_torch.serving.workload import PoissonWorkload


# ------------------------------------------------------------ queues
def test_queue_slo_priority_order():
    q = RequestQueue("m")
    for slo in (100.0, 20.0, 50.0, 20.0):
        q.push(Request("m", "image", (3,), slo, arrival_ms=0.0))
    batch = q.pop_batch(4)
    assert [r.slo_ms for r in batch] == [20.0, 20.0, 50.0, 100.0]


def test_queue_fifo_within_priority():
    q = RequestQueue("m")
    rs = [Request("m", "image", (3,), 50.0, arrival_ms=float(i))
          for i in range(5)]
    for r in rs:
        q.push(r)
    assert [r.arrival_ms for r in q.pop_batch(5)] == [0, 1, 2, 3, 4]


def test_queue_drop_at_capacity():
    q = RequestQueue("m", max_len=2)
    ok = [q.push(Request("m", "i", (1,), 10.0, 0.0)) for _ in range(4)]
    assert ok == [True, True, False, False]
    assert q.dropped == 2


# ------------------------------------------------------------ workload
def test_poisson_rate():
    wl = PoissonWorkload(rps=30.0, seed=0)
    reqs = wl.burst(8000)
    dur_s = (reqs[-1].arrival_ms - reqs[0].arrival_ms) / 1000.0
    rate = len(reqs) / dur_s
    assert rate == pytest.approx(30.0 * len(EDGE_MODELS), rel=0.1)


def test_poisson_mix_uniform():
    wl = PoissonWorkload(rps=30.0, seed=1)
    reqs = wl.burst(6000)
    counts = {m: 0 for m in EDGE_MODELS}
    for r in reqs:
        counts[r.model] += 1
    for c in counts.values():
        assert c == pytest.approx(1000, rel=0.25)


def test_decode_steps_are_geometric():
    wl = PoissonWorkload(rps=30.0, seed=0, decode_steps_mean=6.0)
    steps = [wl.next_request().decode_steps for _ in range(4000)]
    assert min(steps) >= 1
    assert np.mean(steps) == pytest.approx(6.0, rel=0.15)
    wl1 = PoissonWorkload(rps=30.0, seed=0)  # default: single-shot
    assert all(wl1.next_request().decode_steps == 1 for _ in range(50))


# ------------------------------------------------------------ latency model
@given(b=st.integers(1, 128), mc=st.integers(1, 8))
@settings(max_examples=60, deadline=None)
def test_latency_positive_and_memory_monotonic(b, mc):
    hw = PLATFORMS["xavier_nx"]
    prof = EDGE_MODELS["yolo"]
    est = lm.estimate_execution(hw, prof, b, mc)
    assert est.compute_ms > 0
    assert est.interference_factor >= 1.0
    est2 = lm.estimate_execution(hw, prof, b, mc + 1)
    assert est2.mem_used_gb > est.mem_used_gb


@given(b=st.integers(1, 64))
@settings(max_examples=40, deadline=None)
def test_batching_amortizes_per_request_compute(b):
    hw = PLATFORMS["xavier_nx"]
    prof = EDGE_MODELS["res"]
    t1 = lm.estimate_execution(hw, prof, b, 1).compute_ms / b
    t2 = lm.estimate_execution(hw, prof, b * 2, 1).compute_ms / (b * 2)
    assert t2 <= t1 + 1e-6


def test_overflow_at_huge_batch():
    hw = PLATFORMS["jetson_nano"]
    prof = EDGE_MODELS["inc"]
    est = lm.estimate_execution(hw, prof, 128, 8)
    assert est.overflow


# ------------------------------------------------------------ env invariants
def _drive(cfg: ServingConfig, seed: int, action, episode_ms=3000.0,
           max_steps=400):
    """Step an env with a fixed action, or ``action(step)``, until done."""
    env = EdgeServingEnv(cfg, episode_ms=episode_ms, seed=seed)
    done, steps = False, 0
    while not done and steps < max_steps:
        a = action(steps) if callable(action) else action
        _, _, done, _ = env.step(a)
        steps += 1
    return env


def _in_flight(env) -> int:
    """Requests held by rounds and sessions still in the event heap."""
    n = 0
    for _, _, kind, payload in env._events:
        if kind == "complete":
            n += payload.n_requests
        elif kind == "iter":
            n += len(payload.active) + len(payload.done)
    return n


def _conserved(env) -> bool:
    served = sum(r.n_requests for r in env.history)
    queued = sum(len(q) for q in env.queues.values())
    dropped = sum(q.dropped for q in env.queues.values())
    return served + queued + _in_flight(env) + dropped == env.total_requests


@given(seed=st.integers(0, 50), action=st.integers(0, 63))
@settings(max_examples=20, deadline=None)
def test_env_conserves_requests(seed, action):
    assert _conserved(_drive(ServingConfig(), seed, action, max_steps=200))


@given(seed=st.integers(0, 30))
@settings(max_examples=10, deadline=None)
def test_env_latencies_nonnegative_and_time_monotone(seed):
    cfg = ServingConfig()
    env = EdgeServingEnv(cfg, episode_ms=3000.0, seed=seed)
    rng = np.random.default_rng(seed)
    done, last_now = False, 0.0
    while not done:
        assert env.now >= last_now
        last_now = env.now
        _, _, done, _ = env.step(int(rng.integers(cfg.n_actions)))
    for rnd in env.history:
        assert rnd.finish_ms >= rnd.start_ms >= rnd.decision_ms
        for lat in rnd.latencies_ms:
            assert lat > 0


def test_env_violation_accounting():
    cfg = ServingConfig()
    env = _drive(cfg, 3, cfg.pair_to_action(128, 8), episode_ms=5000.0,
                 max_steps=10**6)  # absurd batch
    assert env.summarize()["slo_violation_rate"] > 0.3


def test_transitions_are_per_model_consistent():
    env = EdgeServingEnv(ServingConfig(), episode_ms=4000.0, seed=0)
    done = False
    count = 0
    while not done:
        _, _, done, info = env.step(5)
        for (s, a, r, s2, d) in info["transitions"]:
            assert s.shape == s2.shape == (env.state_dim,)
            assert 0 <= a < env.n_actions
            assert np.isfinite(r)
            count += 1
    assert count > 10


# ------------------------------------------------------------ continuous
@pytest.mark.parametrize("seed,action", [(0, 5), (1, 20), (2, 41), (3, 9)])
def test_continuous_conserves_requests(seed, action):
    cfg = ServingConfig(exec_mode="continuous", decode_steps_mean=4.0)
    assert _conserved(_drive(cfg, seed, action))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_continuous_queue_waits_nonnegative(seed):
    cfg = ServingConfig(exec_mode="continuous", decode_steps_mean=4.0)
    env = _drive(cfg, seed, action=12)
    assert env.history, "no sessions completed"
    for rnd in env.history:
        assert rnd.exec_mode == "continuous"
        assert rnd.n_iters >= 1
        assert rnd.finish_ms >= rnd.start_ms >= rnd.decision_ms
        assert len(rnd.queue_waits_ms) == rnd.n_requests
        assert all(w >= 0.0 for w in rnd.queue_waits_ms)
        assert all(lat > 0.0 for lat in rnd.latencies_ms)
        if not rnd.overflow:
            assert len(rnd.request_utilities) == rnd.n_requests


def test_continuous_beats_round_on_decode_heavy():
    """Decode-heavy workload: iteration-level batching must win p50
    latency AND goodput over run-to-completion rounds."""
    summaries = {}
    for mode in ("round", "continuous"):
        cfg = ServingConfig(exec_mode=mode, decode_steps_mean=6.0)
        env = EdgeServingEnv(cfg, episode_ms=8000.0, seed=0)
        res = run_episode(env, FixedScheduler(cfg.pair_to_action(4, 2)),
                          predictor=None, guard=False, learn=False)
        summaries[mode] = res.summary
    assert summaries["continuous"]["p50_latency_ms"] < \
        summaries["round"]["p50_latency_ms"]
    assert summaries["continuous"]["goodput_rps"] >= \
        summaries["round"]["goodput_rps"]


def test_round_mode_single_shot_unchanged():
    env = _drive(ServingConfig(), seed=0, action=5)
    assert env.history
    for rnd in env.history:
        assert rnd.exec_mode == "round"
        assert rnd.n_iters == 1


def test_continuous_sessions_batch_more_than_capacity():
    """Join/leave really happens: with slot capacity b*m_c = 8, sessions
    serve more requests than their initial allocation when the queue is
    deep."""
    cfg = ServingConfig(exec_mode="continuous", decode_steps_mean=4.0,
                        arrival_rps=60.0)
    env = _drive(cfg, seed=0, action=cfg.pair_to_action(4, 2),
                 episode_ms=6000.0)
    assert any(r.n_requests > 8 for r in env.history if not r.overflow)


# ------------------------------------------------------------ preemption
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_preemption_conserves_requests(seed):
    cfg = ServingConfig(exec_mode="continuous", decode_steps_mean=4.0,
                        prefill_tokens_mean=24.0, token_budgets=(0, 16),
                        preemption=True, arrival_rps=60.0)
    assert _conserved(_drive(cfg, seed, lambda i: i % cfg.n_actions))


def test_sim_token_budget_caps_iteration_tokens():
    """With a token budget, a session's planned iteration work never
    exceeds budget (decode rows included once prefill is paid)."""
    reqs = []
    for pf, dec in ((40, 4), (0, 3), (10, 2)):
        r = Request(model="m", input_type="text", input_shape=(1,),
                    slo_ms=1000.0, arrival_ms=0.0, decode_steps=dec,
                    prefill_tokens=pf)
        r.remaining = dec
        r.prefill_remaining = pf
        reqs.append(r)
    sess = _Session("m", 4, 1, 0.0, 0.0, 1e9, 0.0, None, 0,
                    token_budget=8)
    sess.active = reqs
    total, alloc = sess.plan_tokens()
    assert total <= 8
    assert alloc == [7, 0, 0]  # 1 decode row + 7 budgeted prefill tokens
    sess.token_budget = 0
    total, alloc = sess.plan_tokens()
    assert total == 1 + 40 + 10  # uncapped: all prefill in one iteration


# ------------------------------------------------------------ vs the reference
def _same(a, b) -> bool:
    """Exact structural equality: dataclasses field by field, arrays by
    dtype, shape and value, floats bit for bit."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and _same(
            {f.name: getattr(a, f.name) for f in dataclasses.fields(a)},
            {f.name: getattr(b, f.name) for f in dataclasses.fields(b)})
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_same_is_exact():
    """The comparison itself: a one-ulp difference, a dtype or a field
    tells two values apart."""
    x = np.float32(0.1)
    assert _same({"a": [x, 1.0]}, {"a": [np.float32(0.1), 1.0]})
    assert not _same(x, np.nextafter(x, np.float32(1)))
    assert not _same(np.zeros(2, np.float32), np.zeros(2, np.float64))
    assert not _same(1.0, 1.0 + 2 ** -52)
    assert not _same(0, 0.0)


def test_copies_match_the_reference():
    """Profiles, the three paper platforms and every analytic function of
    the latency model equal the reference's; the port leaves tpu_v5e
    out."""
    assert EDGE_MODELS.keys() == JAX_EDGE_MODELS.keys()
    for m in EDGE_MODELS:
        assert dataclasses.asdict(EDGE_MODELS[m]) == \
            dataclasses.asdict(JAX_EDGE_MODELS[m])
    assert set(PLATFORMS) == set(JAX_PLATFORMS) - {"tpu_v5e"}
    for name, hw in PLATFORMS.items():
        jhw = JAX_PLATFORMS[name]
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
        for m in EDGE_MODELS:
            prof, jprof = EDGE_MODELS[m], JAX_EDGE_MODELS[m]
            assert lm.transmission_ms(hw, prof) == \
                jax_lm.transmission_ms(jhw, jprof)
            for b in (1, 3, 16, 128):
                assert lm.instance_memory_gb(prof, b) == \
                    jax_lm.instance_memory_gb(jprof, b)
                assert lm.batching_efficiency(hw, b) == \
                    jax_lm.batching_efficiency(jhw, b)
                assert lm.serialization_ms(b) == jax_lm.serialization_ms(b)
                for mc, oi, om in ((1, 0, 0.0), (4, 3, 2.5), (8, 9, 7.9)):
                    assert dataclasses.asdict(lm.estimate_execution(
                        hw, prof, b, mc, oi, om)) == dataclasses.asdict(
                        jax_lm.estimate_execution(jhw, jprof, b, mc, oi, om))
                    assert lm.peak_throughput_rps(hw, prof, b, mc) == \
                        jax_lm.peak_throughput_rps(jhw, jprof, b, mc)
                    assert lm.interference_factor(hw, mc + oi, om) == \
                        jax_lm.interference_factor(jhw, mc + oi, om)
    models = list(EDGE_MODELS)
    assert features.state_dim(models) == jax_features.state_dim(models)
    assert features.queue_feature_index(models) == \
        jax_features.queue_feature_index(models)
    for m, args in (("yolo", (0, 0.0, 0.0, 0, 0.0)),
                    ("bert", (17, 250.0, 6.5, 5, 0.7))):
        assert _same(features.featurize(m, models, PLATFORMS["xavier_nx"],
                                        *args),
                     jax_features.featurize(m, models,
                                            JAX_PLATFORMS["xavier_nx"],
                                            *args))


@pytest.mark.parametrize("kw", [
    {}, {"decode_steps_mean": 4.0, "prefill_tokens_mean": 24.0},
    {"shared_prefix_tokens": 32.0, "prefix_population": 3,
     "decode_steps_mean": 2.0}])
def test_workload_draws_match_the_reference(kw):
    """The same seed draws the same requests, in the same order, through
    ``next_request`` and ``until``."""
    ours, ref = PoissonWorkload(seed=7, **kw), JaxWorkload(seed=7, **kw)
    keep = ("model", "input_type", "input_shape", "slo_ms", "arrival_ms",
            "decode_steps", "prefill_tokens", "prefix_id", "prefix_tokens")

    def fields(r):
        return {k: getattr(r, k) for k in keep}

    for _ in range(300):
        assert _same(fields(ours.next_request()), fields(ref.next_request()))
    for t in (ours.now_ms + 200.0, ours.now_ms + 900.0):
        assert _same([fields(r) for r in ours.until(t)],
                     [fields(r) for r in ref.until(t)])
        assert ours.now_ms == ref.now_ms


#: the five differential configs: round; continuous; chunked prefill
#: under token budgets with preemption; shared prefixes with the prefix
#: cache; speculation
SIM_CONFIGS = {
    "round": {},
    "continuous": {"exec_mode": "continuous", "decode_steps_mean": 4.0},
    "chunked_preemption": {"exec_mode": "continuous",
                           "decode_steps_mean": 4.0,
                           "prefill_tokens_mean": 24.0,
                           "token_budgets": (0, 32), "preemption": True,
                           "arrival_rps": 60.0},
    "prefix_cache": {"exec_mode": "continuous", "decode_steps_mean": 3.0,
                     "prefill_tokens_mean": 8.0,
                     "shared_prefix_tokens": 32.0, "prefix_cache": True},
    "speculation": {"exec_mode": "continuous", "decode_steps_mean": 6.0,
                    "spec_depths": (0, 2)},
}


def _two_slo_classes(cls):
    """``cls`` with every second request's SLO four times laxer. A victim
    of preemption must hold a strictly laxer SLO than the urgent request,
    and the Table-IV workload gives every request of a model that model's
    SLO, so without a second class the simulator never preempts."""

    class TwoClasses(cls):
        def next_request(self):
            r = super().next_request()
            self.n_drawn = getattr(self, "n_drawn", 0) + 1
            if self.n_drawn % 2 == 0:
                r.slo_ms *= 4.0
            return r

    return TwoClasses


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SIM_CONFIGS))
def test_env_steps_exactly_as_the_reference(name, seed, monkeypatch):
    """Seeded random actions (b up to 8, m_c up to 3, every token budget
    and depth) through both envs: every step's state, reward, done and
    info, every completed round and the summary are identical; each
    config's feature really ran."""
    import repro.serving.simulator as jax_sim
    import repro_torch.serving.simulator as sim

    if name == "chunked_preemption":
        for mod in (sim, jax_sim):
            monkeypatch.setattr(mod, "PoissonWorkload",
                                _two_slo_classes(mod.PoissonWorkload))
    kw = SIM_CONFIGS[name]
    cfg = ServingConfig(**kw)
    ours = EdgeServingEnv(cfg, episode_ms=4000.0, seed=seed)
    ref = JaxEnv(JaxServingConfig(**kw), episode_ms=4000.0, seed=seed)
    assert _same(ours.reset(), ref.reset())
    rng = np.random.default_rng(100 + seed)
    done, steps = False, 0
    while not done:
        a = cfg.quad_to_action(int(rng.choice(cfg.batch_sizes[:4])),
                               int(rng.choice(cfg.concurrency_levels[:3])),
                               int(rng.choice(cfg.token_budgets)),
                               int(rng.choice(cfg.spec_depths)))
        got, want = ours.step(a), ref.step(a)
        assert _same(got, want), f"{name}: step {steps} differs"
        done = got[2]
        steps += 1
    assert steps >= 10 and len(ours.history) >= 4
    assert _same(ours.history, ref.history)
    assert _same(ours.summarize(), ref.summarize())
    for attr in ("now", "total_requests", "prefix_hit_tokens",
                 "spec_proposed", "spec_accepted"):
        assert _same(getattr(ours, attr), getattr(ref, attr)), attr
    assert _same({m: (len(q), q.dropped) for m, q in ours.queues.items()},
                 {m: (len(q), q.dropped) for m, q in ref.queues.items()})
    ran = {"chunked_preemption": sum(r.n_preempted for r in ours.history),
           "prefix_cache": ours.prefix_hit_tokens,
           "speculation": ours.spec_accepted}
    assert ran.get(name, 1) > 0, f"{name}: the feature never ran"
