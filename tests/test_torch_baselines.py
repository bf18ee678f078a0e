"""The port's baseline schedulers (``repro_torch.core.baselines``) against
the JAX package, on the CPU: the mirror of the baseline tests of
tests/test_core_sac.py, then parity.

Parity: a JAX agent's nets cross into the port through
``repro_torch.models.bridge`` (``tac_nets_from_jax``, ``ppo_nets_from_jax``,
``ddqn_nets_from_jax``); both agents take the same transitions (TAC and
DDQN: the same replay seed, so the same ``sample()`` draws; PPO: the same
rollout with the same stored log-probabilities) and run three updates.
Losses and every net must then agree to atol = rtol = 1e-5 (fp32
gradients and Adam steps summed in another order); PPO's updates are
held one at a time from the reference's state, for the reason its test
gives. Greedy actions are
equal; DDQN's epsilon-greedy actions too, since its exploration draws
come from the same numpy RNG. GA, EDF and Fixed are numpy copies and give
identical action sequences for the same seed and states. Sampled actions
are not compared: torch's generator cannot reproduce ``jax.random``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config.base import ServingConfig as JaxServingConfig
from repro.core import baselines as jax_bl
from repro.serving.features import queue_feature_index
from repro_torch.config.base import ServingConfig
from repro_torch.core import baselines as bl
from repro_torch.core.baselines import (DDQNAgent, EDFScheduler,
                                        FixedScheduler, GAScheduler,
                                        PPOAgent, TACAgent)
from repro_torch.models import bridge

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Bandit:
    """Contextual bandit: best action = argmax ctx-dependent payoff (the
    environment of tests/test_core_sac.py)."""

    def __init__(self, dim=6, n_actions=8, seed=0):
        self.rng = np.random.default_rng(seed)
        self.w = self.rng.standard_normal((dim, n_actions)) * 0.5
        self.dim, self.n_actions = dim, n_actions

    def ctx(self):
        return self.rng.standard_normal(self.dim).astype(np.float32)

    def reward(self, s, a):
        return float(s @ self.w[:, a]) + 0.05 * self.rng.standard_normal()


def _train(agent, env, steps):
    s = env.ctx()
    for _ in range(steps):
        a = agent.act(s)
        s2 = env.ctx()
        agent.observe(s, a, env.reward(s, a), s2, False)
        agent.update()
        s = s2


def _greedy_regret(agent, env, n=300):
    regret = 0.0
    for _ in range(n):
        s = env.ctx()
        a = agent.act(s, greedy=True)
        regret += float(np.max(s @ env.w)) - float(s @ env.w[:, a])
    return regret / n


# ------------------------------------------------------------ mirrored
@pytest.mark.parametrize("cls", [TACAgent, DDQNAgent])
def test_baseline_agents_learn_bandit(cls):
    """The reference test's regret bound at its learning rate, discount,
    mini-batch and steps."""
    env = Bandit()
    agent = cls(env.dim, env.n_actions, lr=3e-3, gamma=0.0,
                batch_size=128, seed=1, device="cpu")
    _train(agent, env, 1500)
    assert _greedy_regret(agent, env) < 0.6


def test_ppo_runs_and_improves():
    env = Bandit()
    agent = PPOAgent(env.dim, env.n_actions, lr=3e-3, gamma=0.0,
                     horizon=128, seed=1, device="cpu")
    before = _greedy_regret(agent, env)
    _train(agent, env, 2000)
    assert _greedy_regret(agent, env) < before


def test_ga_converges_to_good_action():
    env = Bandit(dim=4, n_actions=6, seed=2)
    # GA optimises a static action: use a fixed context
    s_fixed = env.ctx()
    ga = GAScheduler(env.dim, env.n_actions, pop=12, seed=0)
    for _ in range(800):
        a = ga.act(s_fixed)
        ga.observe(s_fixed, a, env.reward(s_fixed, a), s_fixed, False)
        ga.update()
    chosen = ga.act(s_fixed, greedy=True)
    payoffs = s_fixed @ env.w
    assert payoffs[chosen] >= np.sort(payoffs)[-3]  # top-3 action


def test_edf_and_fixed_interfaces():
    cfg = ServingConfig()
    edf = EDFScheduler(cfg.batch_sizes, cfg.concurrency_levels,
                       queue_feature_index(["a", "b"]))
    s = np.zeros(10, np.float32)
    s[queue_feature_index(["a", "b"])] = np.log1p(8)
    b, mc = cfg.action_to_pair(edf.act(s))
    assert b <= 8 and mc == 1
    assert FixedScheduler(5).act(s) == 5


def test_learning_agents_need_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TACAgent, PPOAgent, DDQNAgent):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(4, 4)


# ------------------------------------------------------------ vs the reference
def _state_np(agent) -> dict:
    return jax.tree.map(np.asarray, agent.state._asdict())


def _assert_nets_equal(ours, ref_state: dict, names):
    for name in names:
        net = getattr(ours, name)
        for i, layer in enumerate(ref_state[name]["layers"]):
            np.testing.assert_allclose(net.w[i].detach().numpy(), layer["w"],
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{name} w{i}")
            np.testing.assert_allclose(net.b[i].detach().numpy(), layer["b"],
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{name} b{i}")


def _transitions(dim, n_act, n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(dim).astype(np.float32),
             int(rng.integers(n_act)), float(rng.standard_normal()),
             rng.standard_normal(dim).astype(np.float32),
             bool(rng.random() < 0.2)) for _ in range(n)]


def _assert_metrics_equal(got, want, step):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=f"{key} @ {step}")


@pytest.mark.parametrize("name", ["tac", "ddqn"])
def test_replay_agents_update_as_the_reference(name):
    """Bridged nets, the same replay contents and draws, three updates:
    losses and every net agree (DDQN's target net after its Polyak
    sync too)."""
    dim, n_act, batch = 6, 8, 32
    jcls, cls, to_port = {
        "tac": (jax_bl.TACAgent, TACAgent, bridge.tac_nets_from_jax),
        "ddqn": (jax_bl.DDQNAgent, DDQNAgent, bridge.ddqn_nets_from_jax),
    }[name]
    ref = jcls(dim, n_act, batch_size=batch, seed=3)
    ours = cls(dim, n_act, batch_size=batch, seed=3, device="cpu")
    ours.load_nets(to_port(_state_np(ref)))
    for t in _transitions(dim, n_act, 3 * batch):
        ref.observe(*t)
        ours.observe(*t)
    for step in range(3):
        _assert_metrics_equal(ours.update(), ref.update(), step)
    _assert_nets_equal(ours, _state_np(ref), cls.NETS)


def _sync_ppo(ours, ref):
    """The reference PPO agent's nets, Adam moments and stored rollout
    values into the port's agent."""
    ours.load_nets(bridge.ppo_nets_from_jax(_state_np(ref)))
    for net, opt, st in ((ours.policy, ours.opt_p, ref.state.opt_p),
                         (ours.value, ours.opt_v, ref.state.opt_v)):
        mu, nu = (bridge.mlp_from_jax(jax.tree.map(np.asarray, t))
                  for t in (st.mu, st.nu))
        for name, p in net.named_parameters():
            s = opt.state[p]
            if s:  # before the first step both start from zero moments
                s["exp_avg"].copy_(mu[name])
                s["exp_avg_sq"].copy_(nu[name])
                s["step"].fill_(float(np.asarray(st.step)))
    ours.buf = [b[:4] + (rb[4],) + b[5:] for b, rb in zip(ours.buf, ref.buf)]


def test_ppo_updates_as_the_reference():
    """Three rollouts of one horizon each, the same stored
    log-probabilities, four epochs an update. Each rollout's stored values
    come from the bridged value net and agree with the reference's; each
    update, started from the reference's nets, Adam moments and stored
    values, gives its losses and both nets within 1e-5. Left free over
    the three updates (12 Adam steps, each rollout's values read from the
    nets the previous update left) the third update's value net drifted
    to 1.7e-4 of the reference's: GAE feeds the nets' own 1e-7
    differences back as targets, and Adam's normalised step amplifies
    them."""
    dim, n_act, horizon = 6, 8, 32
    ref = jax_bl.PPOAgent(dim, n_act, horizon=horizon, seed=3)
    ours = PPOAgent(dim, n_act, horizon=horizon, seed=3, device="cpu")
    ours.load_nets(bridge.ppo_nets_from_jax(_state_np(ref)))
    rng = np.random.default_rng(2)
    for step in range(3):
        for t in _transitions(dim, n_act, horizon, seed=10 + step):
            logp = float(rng.normal(-2.0, 0.5))
            ref._last_logp = ours._last_logp = logp
            ref.observe(*t)
            ours.observe(*t)
        assert [b[3] for b in ours.buf] == [b[3] for b in ref.buf]
        np.testing.assert_allclose([b[4] for b in ours.buf],
                                   [b[4] for b in ref.buf],
                                   atol=TOL if step == 0 else 1e-4,
                                   rtol=TOL)
        _sync_ppo(ours, ref)
        _assert_metrics_equal(ours.update(), ref.update(), step)
        _assert_nets_equal(ours, _state_np(ref), PPOAgent.NETS)
        assert ours.buf == ref.buf == []


def test_greedy_and_epsilon_actions_match_the_reference():
    """With bridged nets every agent's greedy action equals the
    reference's on the same states, and DDQN's whole epsilon-greedy
    sequence does (the epsilon draws share one numpy stream)."""
    dim, n_act = 14, 64
    rng = np.random.default_rng(5)
    states = rng.standard_normal((200, dim)).astype(np.float32)
    for jcls, cls, to_port in (
            (jax_bl.TACAgent, TACAgent, bridge.tac_nets_from_jax),
            (jax_bl.PPOAgent, PPOAgent, bridge.ppo_nets_from_jax),
            (jax_bl.DDQNAgent, DDQNAgent, bridge.ddqn_nets_from_jax)):
        ref, ours = jcls(dim, n_act, seed=4), cls(dim, n_act, seed=4,
                                                  device="cpu")
        ours.load_nets(to_port(_state_np(ref)))
        assert [ours.act(s, greedy=True) for s in states] == \
            [ref.act(s, greedy=True) for s in states], cls.name
    ref = jax_bl.DDQNAgent(dim, n_act, seed=6, eps_decay=0.01)
    ours = DDQNAgent(dim, n_act, seed=6, eps_decay=0.01, device="cpu")
    ours.load_nets(bridge.ddqn_nets_from_jax(_state_np(ref)))
    assert [ours.act(s) for s in states] == [ref.act(s) for s in states]
    assert ours.steps == ref.steps and ours.epsilon == ref.epsilon


def test_sampled_actions_are_seeded():
    """Sampling draws from the agent's own generator: the same seed gives
    the same actions, another seed others."""
    states = np.random.default_rng(0).standard_normal((64, 6)).astype(
        np.float32)

    def sample(cls, seed):
        agent = cls(6, 8, seed=seed, device="cpu")
        return [agent.act(s) for s in states]

    for cls in (TACAgent, PPOAgent):
        assert sample(cls, 1) == sample(cls, 1)
        assert sample(cls, 1) != sample(cls, 2)


def test_heuristics_match_the_reference():
    """GA (a seeded population evolved on the same rewards), EDF (states
    from the featurizer over many queues and ages, on every platform) and
    Fixed give the reference's action sequences."""
    rng = np.random.default_rng(9)
    ga, jga = GAScheduler(14, 64, seed=2), jax_bl.GAScheduler(14, 64, seed=2)
    s = np.zeros(14, np.float32)
    for i in range(600):
        a = ga.act(s, greedy=i % 7 == 0)
        assert a == jga.act(s, greedy=i % 7 == 0)
        r = float(rng.standard_normal())
        ga.observe(s, a, r, s, False)
        jga.observe(s, a, r, s, False)
        assert ga.update() == jga.update()
        np.testing.assert_array_equal(ga.pop, jga.pop)
    cfg, jcfg = ServingConfig(), JaxServingConfig()
    from repro_torch.configs.paper_edge_models import EDGE_MODELS
    from repro_torch.serving.features import featurize
    from repro_torch.serving.platforms import PLATFORMS

    models = list(EDGE_MODELS)
    qi = queue_feature_index(models)
    for platform in sorted(PLATFORMS):
        edf = EDFScheduler(cfg.batch_sizes, cfg.concurrency_levels, qi,
                           platform=platform)
        jedf = jax_bl.EDFScheduler(jcfg.batch_sizes, jcfg.concurrency_levels,
                                   qi, platform=platform)
        picks = []
        for _ in range(200):
            m = models[int(rng.integers(len(models)))]
            st = featurize(m, models, PLATFORMS[platform],
                           int(rng.integers(0, 300)),
                           float(rng.uniform(0, 150)),
                           float(rng.uniform(0, 6)), int(rng.integers(9)),
                           float(rng.random()))
            picks.append(edf.act(st))
            assert picks[-1] == jedf.act(st)
        assert len(set(picks)) > 2, platform  # more than one batch size
    assert FixedScheduler(7).act(s) == jax_bl.FixedScheduler(7).act(s)
    assert bl.FixedScheduler(7).update() == {}
