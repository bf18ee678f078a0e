"""The port's simulator path end to end, on the CPU: the performance
profiler and SAC deployment checkpoints (the mirror of
tests/test_profiler_deploy.py, with the port's checkpoint format), the
simulator tests of tests/test_integration.py (an episode end to end, the
guard), ``run_episode`` and ``collect_interference_dataset`` against the
JAX package, and the simulator CLI.

``run_episode`` parity: the reference's SAC nets bridged in
(``bridge.sac_nets_from_jax``) and acting greedily with learning off, the
port gives the reference's history exactly, with the guard off and on.
With the guard on, both predictors start from the reference's net
(``bridge.interference_from_jax``) and train online on the same rounds;
they agree only to about 5e-5 relative (tests/test_torch_interference.py),
so a guard verdict could flip where a prediction lies that close to its
budget, and a greedy action where two logits tie in fp32. The rule:
every agent action and predictor call is traced on both sides; up to the
first event whose input or action differs the histories must be equal,
and that first difference must be shown to be such a tie (the logit
margin under 1e-4, or the two predictions, between which the budget must
lie, within TIE of each other); anything else is a fault.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ServingConfig as JaxServingConfig
from repro.core.interference import NNInterferencePredictor as JaxPredictor
from repro.core.networks import mlp_apply
from repro.core.sac import SACAgent as JaxSAC
from repro.core.sac import SACConfig as JaxSACConfig
from repro.serving.bcedge import collect_interference_dataset as jax_collect
from repro.serving.bcedge import run_episode as jax_run_episode
from repro.serving.profiler import PerformanceProfiler as JaxProfiler
from repro.serving.simulator import EdgeServingEnv as JaxEnv
from repro_torch.config.base import ServingConfig
from repro_torch.core.baselines import FixedScheduler
from repro_torch.core.interference import NNInterferencePredictor
from repro_torch.core.sac import NETS, SACAgent, SACConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models.bridge import interference_from_jax, sac_nets_from_jax
from repro_torch.serving.bcedge import (BCEdgeScheduler,
                                        collect_interference_dataset,
                                        run_episode)
from repro_torch.serving.features import state_dim
from repro_torch.serving.profiler import PerformanceProfiler
from repro_torch.serving.simulator import EdgeServingEnv

#: relative gap two predictions may have at a shown guard tie (the
#: predictors' end-to-end agreement is 5e-5, tests/test_torch_interference.py)
TIE = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- profiler
def cfg_action(b, mc):
    return ServingConfig().pair_to_action(b, mc)


def _run_with_profiler(action, seed=0, ms=6000.0, env_cls=EdgeServingEnv,
                       prof_cls=PerformanceProfiler, cfg_cls=ServingConfig):
    env = env_cls(cfg_cls(), episode_ms=ms, seed=seed)
    prof = prof_cls()
    agent = FixedScheduler(action)
    s = env.reset()
    prof.reset_env()
    done = False
    while not done:
        s, _, done, _ = env.step(agent.act(s))
        prof.poll(env)
    return env, prof


def test_profiler_collects_rounds():
    env, prof = _run_with_profiler(cfg_action(2, 2))
    total = sum(e.total_requests for e in prof.table.values())
    assert total == sum(r.n_requests for r in env.history)
    for (m, b, mc) in prof.table:  # all records belong to the config
        assert (b, mc) == (2, 2)


def test_profiler_summary_fields():
    _, prof = _run_with_profiler(cfg_action(4, 1))
    s = prof.profile(*next(iter(prof.table)))
    assert s["rounds"] >= 1
    assert s["mean_latency_ms"] > 0
    assert 0 <= s["violation_rate"] <= 1
    assert 0 <= prof.utilization()["busy_frac"] <= 1


def test_profiler_best_config_prefers_feasible():
    cfg = ServingConfig()
    env = EdgeServingEnv(cfg, episode_ms=12_000.0, seed=3)
    prof = PerformanceProfiler()
    rng = np.random.default_rng(0)
    env.reset()
    done = False
    # explore a few configs so the table has alternatives
    actions = [cfg.pair_to_action(b, mc)
               for b, mc in ((1, 1), (2, 2), (64, 8))]
    while not done:
        _, _, done, _ = env.step(actions[int(rng.integers(len(actions)))])
        prof.poll(env)
    best = prof.best_config("yolo", max_violation=0.6)
    if best is not None:  # enough data collected
        assert best != (64, 8)  # the pathological config never wins


def test_fig1_surface_shape():
    _, prof = _run_with_profiler(cfg_action(2, 1))
    surf = prof.fig1_surface("res")
    assert surf and all(len(k) == 2 for k in surf)


def test_profiler_matches_the_reference():
    """The same run profiled by both packages: every table entry's
    summary, the best configurations and the utilization are equal."""
    action = cfg_action(4, 2)
    _, ours = _run_with_profiler(action, seed=1)
    _, ref = _run_with_profiler(action, seed=1, env_cls=JaxEnv,
                                prof_cls=JaxProfiler,
                                cfg_cls=JaxServingConfig)
    assert ours.table.keys() == ref.table.keys()
    for key in ours.table:
        assert ours.profile(*key) == ref.profile(*key)
    for m in {k[0] for k in ours.table}:
        assert ours.best_config(m, 0.5) == ref.best_config(m, 0.5)
        assert ours.fig1_surface(m) == ref.fig1_surface(m)
    assert ours.utilization() == ref.utilization()


# ---------------------------------------------------------------- deploy
def test_sac_save_load_roundtrip(tmp_path):
    agent = SACAgent(10, 16, SACConfig(batch_size=8), seed=0, device="cpu")
    # a few updates so weights move off init
    rng = np.random.default_rng(0)
    for _ in range(32):
        s = rng.standard_normal(10).astype(np.float32)
        agent.observe(s, int(rng.integers(16)), float(rng.random()),
                      rng.standard_normal(10).astype(np.float32), False)
    agent.update()
    path = agent.save(os.path.join(tmp_path, "sac.pt"))
    meta = torch.load(path, weights_only=True)["meta"]
    assert meta == {"n_actions": 16, "step": 1}

    fresh = SACAgent(10, 16, SACConfig(batch_size=8), seed=99, device="cpu")
    probe = np.random.default_rng(1).standard_normal((32, 10)).astype(
        np.float32)
    assert [fresh.act(p, greedy=True) for p in probe] != \
        [agent.act(p, greedy=True) for p in probe]
    fresh.load(path)
    assert [fresh.act(p, greedy=True) for p in probe] == \
        [agent.act(p, greedy=True) for p in probe]
    for name in NETS:
        for a, b in zip(getattr(fresh, name).parameters(),
                        getattr(agent, name).parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fresh.log_alpha.item() == agent.log_alpha.item()


def test_sac_load_rejects_mismatched_actions(tmp_path):
    agent = SACAgent(10, 16, seed=0, device="cpu")
    path = agent.save(os.path.join(tmp_path, "sac.pt"))
    other = SACAgent(10, 8, seed=0, device="cpu")
    with pytest.raises(ValueError, match="action-space"):
        other.load(path)


# ---------------------------------------------------------------- episode
def test_sac_episode_end_to_end():
    cfg = ServingConfig()
    env = EdgeServingEnv(cfg, episode_ms=6000.0, seed=0)
    agent = SACAgent(state_dim(env.models), cfg.n_actions,
                     SACConfig(batch_size=64), seed=0, device="cpu")
    pred = NNInterferencePredictor(device="cpu")
    res = run_episode(env, agent, pred, guard=True)
    s = res.summary
    assert s["requests"] > 100
    assert 0 <= s["slo_violation_rate"] <= 1
    assert np.isfinite(s["mean_utility"])
    assert len(res.overhead_ms) > 10
    assert res.losses and agent.step > 0  # it learned on the episode


def test_guard_degrades_infeasible_actions():
    cfg = ServingConfig()
    env = EdgeServingEnv(cfg, episode_ms=3000.0, seed=1)

    class AlwaysMax:
        def act(self, s, greedy=False):
            return cfg.n_actions - 1  # b=128, m_c=8

    pred = NNInterferencePredictor(device="cpu")
    # teach the predictor that big rounds are slow
    for _ in range(80):
        pred.observe(env.predict_features("yolo", 128, 8), 30.0)
        pred.observe(env.predict_features("yolo", 1, 1), 0.02)
    pred.fit_step()
    sched = BCEdgeScheduler(env, AlwaysMax(), pred, guard=True)
    s = env.reset()
    b, mc = cfg.action_to_pair(sched.select_action(s, env._focus))
    assert (b, mc) != (128, 8)
    assert sched.guard_interventions == 1


def test_episode_with_guard_no_worse_violations():
    """The reference test: three 8 s episodes a side, a learning SAC
    agent; the guard must not make violations catastrophically worse."""
    cfg = ServingConfig()
    results = {}
    for guard in (False, True):
        agent = SACAgent(state_dim(EdgeServingEnv(cfg, episode_ms=1).models),
                         cfg.n_actions, SACConfig(batch_size=128), seed=3,
                         device="cpu")
        pred = NNInterferencePredictor(device="cpu") if guard else None
        viols = []
        for ep in range(3):
            env = EdgeServingEnv(cfg, episode_ms=8000.0, seed=ep)
            res = run_episode(env, agent, pred, guard=guard)
            viols.append(res.summary["slo_violation_rate"])
        results[guard] = np.mean(viols)
    assert results[True] <= results[False] + 0.25


# ---------------------------------------------------------------- parity
class _Traced:
    """A greedy agent that records every action it takes, with the state,
    the top-two logit margin and the simulated time."""

    def __init__(self, agent, logits, env, events):
        self.agent, self.logits, self.env, self.events = \
            agent, logits, env, events

    def act(self, s, greedy=False):
        a = self.agent.act(s, greedy=True)
        top2 = np.sort(np.asarray(self.logits(s), np.float64))[-2:]
        self.events.append(("act", np.asarray(s).copy(), a,
                            float(top2[1] - top2[0]), self.env.now))
        return a


def _trace_predictions(pred, env, events):
    """Record every guard prediction (features, value, simulated time)."""
    inner = pred.predict

    def predict(feats):
        y = inner(feats)
        events.append(("pred", np.asarray(feats).copy(), y, None, env.now))
        return y

    pred.predict = predict


def _first_divergence(ours, ref):
    """Index of the first event whose kind, input or action differs, and
    the event that caused it; None where the traces are identical."""
    for i, (x, y) in enumerate(zip(ours, ref)):
        if x[0] != y[0] or not np.array_equal(x[1], y[1]):
            return i, i - 1  # an earlier output (a guard verdict) differed
        if x[0] == "act" and x[2] != y[2]:
            return i, i
    if len(ours) != len(ref):
        n = min(len(ours), len(ref))
        return n, n - 1
    return None


def _assert_same_schedule(ours_env, ref_env, ours_ev, ref_ev):
    """Identical histories, or identical ones up to a shown tie."""
    div = _first_divergence(ours_ev, ref_ev)
    t_cut = float("inf")
    if div is not None:
        at, cause = div
        x, y = ours_ev[cause], ref_ev[cause]
        if x[0] == "act":
            assert min(x[3], y[3]) < 1e-4, \
                f"greedy actions differ at event {cause}, margin {x[3]}"
        else:
            gap = abs(x[2] - y[2]) / y[2]
            assert gap < TIE, \
                f"guard verdicts differ at event {cause}: predictions " \
                f"{x[2]} and {y[2]} (relative gap {gap:.2e}) are no tie"
        t_cut = x[4]
    keep = [r for r in ref_env.history if r.decision_ms < t_cut]
    got = [r for r in ours_env.history if r.decision_ms < t_cut]
    assert len(got) == len(keep) > 20
    for r, w in zip(got, keep):
        for f in ("model", "b", "m_c", "n_requests", "decision_ms",
                  "start_ms", "finish_ms", "latencies_ms", "violations",
                  "overflow", "utility", "mem_used_gb"):
            assert getattr(r, f) == getattr(w, f), f
        assert np.array_equal(r.features, w.features)
    if div is None:
        assert ours_env.summarize() == ref_env.summarize()


@pytest.mark.parametrize("guard", [False, True])
def test_greedy_episode_matches_the_reference(guard):
    """Bridged SAC nets acting greedily, learning off: the port's
    ``run_episode`` schedules as the reference's, round for round."""
    jcfg, cfg = JaxServingConfig(), ServingConfig()
    ref_env = JaxEnv(jcfg, episode_ms=6000.0, seed=2)
    ours_env = EdgeServingEnv(cfg, episode_ms=6000.0, seed=2)
    jsac = JaxSAC(ours_env.state_dim, cfg.n_actions,
                  JaxSACConfig(batch_size=256, lr=5e-4), seed=0)
    sac = SACAgent(ours_env.state_dim, cfg.n_actions,
                   SACConfig(batch_size=256, lr=5e-4), seed=0, device="cpu")
    nets = {name: getattr(jsac.state, name) for name in NETS}
    nets["log_alpha"] = jsac.state.log_alpha
    sac.load_nets(sac_nets_from_jax(jax.tree.map(np.asarray, nets)))
    ref_ev, ours_ev = [], []
    ref_agent = _Traced(jsac, lambda s: mlp_apply(jsac.state.policy,
                                                  jnp.asarray(s)),
                        ref_env, ref_ev)
    ours_agent = _Traced(sac, lambda s: sac.policy(torch.as_tensor(
        s, dtype=torch.float32)).detach(), ours_env, ours_ev)
    ref_pred = pred = None
    if guard:
        ref_pred = JaxPredictor()
        pred = NNInterferencePredictor(device="cpu")
        pred.load_net(interference_from_jax(
            jax.tree.map(np.asarray, ref_pred.state.net)))
        _trace_predictions(ref_pred, ref_env, ref_ev)
        _trace_predictions(pred, ours_env, ours_ev)
    want = jax_run_episode(ref_env, ref_agent, ref_pred, guard=guard,
                           learn=False)
    got = run_episode(ours_env, ours_agent, pred, guard=guard, learn=False)
    _assert_same_schedule(ours_env, ref_env, ours_ev, ref_ev)
    if guard:
        preds = [e for e in ours_ev if e[0] == "pred"]
        assert len(preds) > 50  # the guard ran, the predictor trained
        assert pred._count > 0
    if _first_divergence(ours_ev, ref_ev) is None:
        assert got.rewards == want.rewards
        assert got.timeline == want.timeline
        assert got.per_model_utility == want.per_model_utility


def test_first_divergence_names_the_cause():
    """The tie rule's bookkeeping: an act whose action differs is its own
    cause; an input that differs blames the event before it."""
    s0, s1 = np.zeros(2), np.ones(2)
    base = [("act", s0, 3, 0.5, 0.0), ("pred", s0, 0.1, None, 0.0)]
    assert _first_divergence(base, list(base)) is None
    assert _first_divergence(base + [("act", s0, 1, 0.5, 1.0)],
                             base + [("act", s0, 2, 0.5, 1.0)]) == (2, 2)
    assert _first_divergence(base + [("act", s1, 1, 0.5, 1.0)],
                             base + [("pred", s0, 0.1, None, 1.0)]) == (2, 1)


def test_collect_interference_dataset_matches_the_reference():
    """The Fig.-13 probe protocol: the same features and latencies, bit for
    bit, across an episode reset."""
    X, y = collect_interference_dataset(ServingConfig(), n=400, seed=1)
    jX, jy = jax_collect(JaxServingConfig(), n=400, seed=1)
    assert X.shape == (400, 7) and X.dtype == jX.dtype == np.float32
    assert y.dtype == jy.dtype == np.float64
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)


# ---------------------------------------------------------------- CLI
def test_cli_runs_the_simulator_on_the_cpu(capsys):
    serve_cli.main(["--episodes", "2", "--episode-ms", "3000", "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert "ep0: utility=" in out and "ep1: utility=" in out
    assert "ms/decision" in out
    serve_cli.main(["--episodes", "1", "--episode-ms", "3000",
                    "--exec-mode", "continuous", "--decode-steps", "4",
                    "--prefill-tokens", "8", "--token-budget", "16",
                    "--preemption", "--shared-prefix-tokens", "16",
                    "--prefix-cache", "--spec-k", "2", "--no-guard",
                    "--platform", "jetson_tx2", "--rps", "20",
                    "--device", "cpu"])
    assert "ep0: utility=" in capsys.readouterr().out


def test_cli_passes_the_simulator_flags_to_the_config(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve_cli, "simulate",
                        lambda cfg, *a, **kw: seen.update(cfg=cfg, a=a, **kw))
    serve_cli.main(["--exec-mode", "continuous", "--decode-steps", "4",
                    "--prefill-tokens", "8", "--token-budget", "16",
                    "--preemption", "--shared-prefix-tokens", "16",
                    "--prefix-cache", "--spec-k", "2", "--no-guard",
                    "--platform", "jetson_nano", "--rps", "20",
                    "--episodes", "3", "--episode-ms", "900"])
    cfg = seen["cfg"]
    assert (cfg.platform, cfg.arrival_rps, cfg.exec_mode) == \
        ("jetson_nano", 20.0, "continuous")
    assert (cfg.decode_steps_mean, cfg.prefill_tokens_mean) == (4.0, 8.0)
    assert cfg.token_budgets == (0, 16) and cfg.spec_depths == (0, 2)
    assert cfg.preemption and cfg.prefix_cache
    assert cfg.shared_prefix_tokens == 16.0
    assert seen["a"] == (3, 900.0) and seen["guard"] is False
    assert seen["device"] == "cuda"
    seen.clear()
    serve_cli.main([])
    assert seen["cfg"] == ServingConfig() and seen["a"] == (6, 20_000.0)
    assert seen["guard"] is True


def test_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit):  # the reference's error
        serve_cli.main(["--models", "qwen3-0.6b", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_cli.main(["--platform", "tpu_v5e", "--device", "cpu"])
    with pytest.raises(SystemExit):  # the reference's ap.error
        serve_cli.main(["--engine", "--prefix-cache", "--device", "cpu"])
    # the prefix cache, the templated workload and speculation are
    # ported: continuous mode passes them to serve_continuous, as the
    # reference's does (round mode ignores them, tests/test_torch_cli.py)
    from repro_torch.launch import engine_serve

    seen = {}
    monkeypatch.setattr(engine_serve, "serve_continuous",
                        lambda *a, **kw: seen.update(kw))
    for flag, want in (
            (["--spec-k", "2"], {"spec_k": 2, "kv_layout": "dense"}),
            (["--prefix-cache", "--kv-layout", "paged"],
             {"prefix_cache": True, "shared_prefix_tokens": 0,
              "kv_layout": "paged", "spec_k": 0}),
            (["--shared-prefix-tokens", "32"],
             {"prefix_cache": False, "shared_prefix_tokens": 32,
              "kv_layout": "dense"})):
        seen.clear()
        serve_cli.main(["--engine", "--exec-mode", "continuous",
                        "--device", "cpu", *flag])
        assert {k: seen[k] for k in want} == want


def test_cli_passes_shared_prefixes_to_the_pool(monkeypatch):
    from repro_torch.launch import engine_serve

    seen = {}
    monkeypatch.setattr(engine_serve, "serve_pool",
                        lambda models, *a, **kw: seen.update(kw))
    serve_cli.main(["--engine", "--models", "qwen3-0.6b", "--kv-layout",
                    "paged", "--shared-prefix-tokens", "500", "--device",
                    "cpu"])
    assert seen["shared_prefix_tokens"] == 500 and seen["device"] == "cpu"


def test_cli_names_why_tpu_v5e_is_refused(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--platform", "tpu_v5e"])
    assert "written for a TPU" in capsys.readouterr().err
