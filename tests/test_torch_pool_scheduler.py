"""The port's ``PoolScheduler`` (``repro_torch.serving.bcedge``) against the
reference's (``repro.serving.bcedge``), on the CPU, and ``serve_pool`` and
its CLI.

For one pool state (the same requests routed or stepped, the same
calibration samples, both pools' clocks held at one instant) the 13-entry
state vectors are equal (float32, the same formulas), the guard's
feasible set is equal over every (b, m_c, token budget) action and the
guard applies the same degraded action; with the reference's SAC nets
bridged in (``bridge.sac_nets_from_jax``), ``act(greedy=True)`` picks the
same action. Arguments the port cannot serve raise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config.base import ModelConfig as JaxModelConfig
from repro.config.base import ServingConfig as JaxServingConfig
from repro.core.sac import SACAgent as JaxSAC
from repro.core.sac import SACConfig as JaxSACConfig
from repro.serving.bcedge import POOL_STATE_DIM as JAX_POOL_STATE_DIM
from repro.serving.bcedge import PoolScheduler as JaxScheduler
from repro.serving.runtime import ModelInstancePool as JaxPool
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.sac import NETS, SACAgent, SACConfig
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli
from repro_torch.models.bridge import sac_nets_from_jax
from repro_torch.serving.bcedge import POOL_STATE_DIM, PoolScheduler
from repro_torch.serving.runtime import ModelInstancePool

SPEC_A = dict(name="tiny-a", family="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=97)
SPEC_B = dict(name="tiny-b", family="dense", n_layers=2, d_model=48,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=83)
SCFG = dict(batch_sizes=(1, 2, 4), concurrency_levels=(1, 2, 3),
            token_budgets=(0, 64, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(monkeypatch, kv_layout="paged", **extra):
    """The reference pool and the port's, with the same instances, the
    same routed requests, the same calibration samples and one frozen
    clock (``extra``: more pool arguments, for both)."""
    kw = dict(max_instances=4, max_slots=4, max_seq=64, seed=0,
              kv_layout=kv_layout, block_size=8,
              kv_block_budget=80 if kv_layout == "paged" else None,
              strict_admission=True, **extra)
    specs = {"tiny-a": SPEC_A, "tiny-b": SPEC_B}
    ref = JaxPool({m: JaxModelConfig(**s) for m, s in specs.items()}, **kw)
    port = ModelInstancePool({m: ModelConfig(**s)
                              for m, s in specs.items()},
                             device="cpu", **kw)
    rng = np.random.default_rng(0)
    reqs = [("tiny-a" if i % 3 else "tiny-b",
             rng.integers(1, 80, int(rng.integers(4, 30))).astype(np.int32),
             float(rng.integers(2, 20)) * 500.0, int(rng.integers(2, 9)))
            for i in range(7)]
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: 0.25)
        pool.scale_to("tiny-a", 2)
        pool.scale_to("tiny-b", 1)
        for m, p, slo, n in reqs:
            pool.submit(m, p, slo_ms=slo, max_new_tokens=n, submit_s=0.0)
        # calibrated so that each guard rejects some actions: about
        # 55 ms per iteration plus 45 % per extra busy instance, 2 ms
        # per token, 60 KV tokens per sequence
        pool.contention_samples = [(n, 30.0 + 25.0 * n + 0.1 * (i % 3))
                                   for i, n in enumerate((1, 2, 3) * 4)]
        pool.token_samples = [(t, 2.0 + 2.0 * t) for t in
                              (1, 8, 16, 32, 3, 9, 40, 64)]
        pool.occupancy_samples = [(n, 60 * n + n % 2) for n in
                                  (1, 2, 3, 4) * 3]
    return ref, port


def _schedulers(ref, port, guard=True):
    jcfg, cfg = JaxServingConfig(**SCFG), ServingConfig(**SCFG)
    kw = dict(slo_ms={"tiny-a": 4000.0, "tiny-b": 6000.0},
              decode_steps_mean=32.0, guard=guard, learn=False)
    return (JaxScheduler(ref, jcfg, **kw), PoolScheduler(port, cfg, **kw))


def test_state_dim_is_the_references():
    assert POOL_STATE_DIM == JAX_POOL_STATE_DIM == 13


@pytest.mark.parametrize("kv_layout", ["paged", "dense"])
def test_state_vectors_are_equal(kv_layout, monkeypatch):
    """After routing (requests waiting inside engines) and after a step
    (prefilled, decoding, KV occupied): the same 13 entries."""
    ref, port = _pools(monkeypatch, kv_layout)
    s_ref, s_port = _schedulers(ref, port)
    for advance in ("route", "step"):
        for pool in (ref, port):
            getattr(pool, advance)()
        for m in ("tiny-a", "tiny-b"):
            want = s_ref._state(m)
            got = s_port._state(m)
            assert got.dtype == want.dtype and got.shape == (13,)
            np.testing.assert_array_equal(got, want, err_msg=f"{m} "
                                          f"after {advance}")
    assert port.kv_used_tokens() == ref.kv_used_tokens() > 0


def test_guard_feasible_set_and_degradation_are_equal(monkeypatch):
    """Every (b, m_c, token budget) action: the same feasibility (KV
    budget, contention and token-cost guards), then the same degraded
    action applied to each pool, leaving the same slot caps, instance
    counts and token budgets."""
    ref, port = _pools(monkeypatch)
    for pool in (ref, port):
        pool.route()
    s_ref, s_port = _schedulers(ref, port)
    cfg = ServingConfig(**SCFG)
    feasible = []
    for m in ("tiny-a", "tiny-b"):
        for a in range(cfg.n_actions):
            b, m_c, tb = cfg.action_to_triple(a)
            want = s_ref._feasible(m, b, m_c, tb)
            assert s_port._feasible(m, b, m_c, tb) == want, (m, b, m_c, tb)
            feasible.append(want)
    assert any(feasible) and not all(feasible)
    for a in range(cfg.n_actions):
        assert s_port._apply("tiny-a", a) == s_ref._apply("tiny-a", a)
        assert port.slot_caps == ref.slot_caps
        assert port.m_c("tiny-a") == ref.m_c("tiny-a")
        assert port.token_budgets == ref.token_budgets
    assert s_port.guard_interventions == s_ref.guard_interventions > 0


def test_speculation_axis_and_host_feature_are_the_references(monkeypatch):
    """The fourth axis: with spec depths (0, 2, 4) and a host tier, every
    action's feasibility (the verify surcharge priced by the token-cost
    fit) and its degradation (speculation shed first) equal the
    reference's, each leaving the same live depth; after speculative
    steps with bridged weights the state vectors (acceptance rate, host
    occupancy) are equal too."""
    ref, port = _pools(monkeypatch, spec_k=4, kv_host_blocks=8)
    port.load_jax_params("tiny-a", jax.tree.map(
        np.asarray, ref.running("tiny-a")[0].engine.params))
    port.load_jax_params("tiny-b", jax.tree.map(
        np.asarray, ref.running("tiny-b")[0].engine.params))
    for pool in (ref, port):
        pool.route()
    spec = dict(SCFG, spec_depths=(0, 2, 4))
    kw = dict(slo_ms={"tiny-a": 4000.0, "tiny-b": 6000.0},
              decode_steps_mean=32.0, guard=True, learn=False)
    s_ref = JaxScheduler(ref, JaxServingConfig(**spec), **kw)
    s_port = PoolScheduler(port, ServingConfig(**spec), **kw)
    cfg = ServingConfig(**spec)
    feasible = []
    for a in range(cfg.n_actions):
        b, m_c, tb, sk = cfg.action_to_quad(a)
        want = s_ref._feasible("tiny-a", b, m_c, tb, sk)
        assert s_port._feasible("tiny-a", b, m_c, tb, sk) == want
        feasible.append(want)
    assert any(feasible) and not all(feasible)
    for a in range(cfg.n_actions):
        assert s_port._apply("tiny-a", a) == s_ref._apply("tiny-a", a)
        assert port.spec_ks == ref.spec_ks
        assert [i.engine.spec_k for i in port.running("tiny-a")] == \
            [i.engine.spec_k for i in ref.running("tiny-a")]
    assert s_port.guard_interventions == s_ref.guard_interventions > 0
    for pool in (ref, port):
        pool.set_spec_k("tiny-a", 4)
        pinned = list(pool.contention_samples)
        for _ in range(6):
            pool.step()
        pool.contention_samples = pinned  # the steps' wall times differ
    assert port.spec_accept_rate() == ref.spec_accept_rate() > 0.0
    for m in ("tiny-a", "tiny-b"):
        np.testing.assert_array_equal(s_port._state(m), s_ref._state(m))


def test_bridged_agent_picks_the_same_greedy_action(monkeypatch):
    """Reference nets in the port's agent: the same greedy (b, m_c) for
    the pool's states and for random states."""
    ref, port = _pools(monkeypatch)
    for pool in (ref, port):
        pool.route()
    s_ref, s_port = _schedulers(ref, port)
    n_act = ServingConfig(**SCFG).n_actions
    rng = np.random.default_rng(1)
    for i, m in enumerate(("tiny-a", "tiny-b")):
        jagent = JaxSAC(13, n_act, JaxSACConfig(batch_size=32, lr=1e-3),
                        seed=i)
        nets = {name: getattr(jagent.state, name) for name in NETS}
        nets["log_alpha"] = jagent.state.log_alpha
        agent = SACAgent(13, n_act, SACConfig(batch_size=32, lr=1e-3),
                         device="cpu")
        agent.load_nets(sac_nets_from_jax(jax.tree.map(np.asarray, nets)))
        states = [s_port._state(m)] + [
            rng.standard_normal(13).astype(np.float32) * 3 for _ in range(20)]
        picks = [agent.act(s, greedy=True) for s in states]
        assert picks == [jagent.act(s, greedy=True) for s in states]
        assert len(set(picks)) > 1


def test_scheduler_drives_real_scaling():
    """tests/test_runtime.py::test_pool_scheduler_drives_real_scaling on
    the port: the applied (b, m_c) is the pool's slot cap and instance
    count, and a second decision closes a transition."""
    pool = ModelInstancePool({"tiny-a": ModelConfig(**SPEC_A)},
                             max_instances=3, max_slots=2, max_seq=64,
                             device="cpu")
    scfg = ServingConfig(batch_sizes=(1, 2), concurrency_levels=(1, 2, 3))
    sched = PoolScheduler(pool, scfg, slo_ms={"tiny-a": 60_000.0},
                          decode_steps_mean=3.0, guard=False, seed=0)
    b, m_c = sched.control()["tiny-a"]
    assert pool.m_c("tiny-a") == m_c >= 1
    assert pool.slot_caps["tiny-a"] == b
    rng = np.random.default_rng(8)
    for _ in range(4):
        pool.submit("tiny-a", rng.integers(1, 97, 6).astype(np.int32),
                    slo_ms=60_000.0, max_new_tokens=2)
        sched.record(pool.step())
    applied = sched.control()
    assert pool.m_c("tiny-a") == applied["tiny-a"][1]
    assert len(sched.agents["tiny-a"].replay) == 1
    pool.run_until_drained()
    assert sched.tick()["tiny-a"] == sched.cfg.action_to_pair(
        sched._last["tiny-a"][1])


def test_unported_axes_raise():
    """TP degrees and speculation depths are ported: the fifth axis sets
    the degree new instances spawn at (the instances at the old degree
    drain), the fourth every live engine's depth, as the reference's
    do."""
    pool = ModelInstancePool({"tiny-a": ModelConfig(**SPEC_A)}, spec_k=4,
                             device="cpu")
    scfg = ServingConfig(**SCFG, tp_degrees=(1, 2))
    sched = PoolScheduler(pool, scfg, guard=False, seed=0)
    for a in (scfg.quint_to_action(2, 2, 0, 0, 2),
              scfg.quint_to_action(1, 1, 0, 0, 1)):
        tp = scfg.action_to_quint(a)[4]
        assert sched._apply("tiny-a", a) == a
        assert pool.tp_degrees["tiny-a"] == tp
        assert {i.tp_degree for i in pool.running("tiny-a")} == {tp}
    scfg = ServingConfig(**SCFG, spec_depths=(0, 2))
    sched = PoolScheduler(pool, scfg, guard=False, seed=0)
    for a in range(scfg.n_actions):
        b, m_c, tb, sk = scfg.action_to_quad(a)
        assert sched._apply("tiny-a", a) == a
        assert [i.engine.spec_k for i in pool.running("tiny-a")] == \
            [sk] * m_c
        assert pool.spec_ks["tiny-a"] == sk


def test_serve_pool_serves_on_the_cpu_when_asked(capsys):
    """The entry point end to end at tiny width: the scheduler decides,
    the pool serves both models, the report has the reference's keys."""
    cfgs = {"tiny-a": ModelConfig(**SPEC_A), "tiny-b": ModelConfig(**SPEC_B)}
    report = engine_serve.serve_pool(duration_s=1.5, rps=20.0,
                                     slo_ms=60_000.0, max_new_tokens=3,
                                     control_ms=300.0, cfgs=cfgs,
                                     kv_layout="paged", kv_block_budget=96,
                                     device="cpu")
    assert sorted(report) == ["tiny-a", "tiny-b"]
    for row in report.values():
        assert row["served"] >= 1 and row["m_c"] >= 1
        assert 0.0 <= row["slo_attainment"] <= 1.0
    out = capsys.readouterr().out
    assert "(b, m_c)=" in out and "guard interventions" in out
    assert "kv_committed_blocks" in out


def test_cli_routes_models_to_serve_pool(monkeypatch):
    seen = {}
    monkeypatch.setattr(engine_serve, "serve_pool",
                        lambda models, *a, **kw: seen.update(
                            models=models, **kw))
    serve_cli.main(["--engine", "--models", "qwen3-0.6b,recurrentgemma-2b",
                    "--max-instances", "3", "--kv-layout", "paged",
                    "--kv-block-budget", "64", "--device", "cpu"])
    assert seen["models"] == ["qwen3-0.6b", "recurrentgemma-2b"]
    assert seen["max_instances"] == 3 and seen["kv_layout"] == "paged"
    assert seen["kv_block_budget"] == 64 and seen["device"] == "cpu"
