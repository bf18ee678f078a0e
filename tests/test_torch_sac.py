"""The port's SAC scheduler core against the JAX package, on the CPU:
``ServingConfig`` and its action codecs, the utility, the replay buffer,
the MLPs and the discrete SAC agent.

Parity: a JAX ``SACAgent``'s nets cross into the port through
``repro_torch.models.bridge.sac_nets_from_jax``; both agents fill their
replay buffers (same seed, so the same ``sample()`` draws) with the same
transitions and run three updates. Losses, ``alpha`` and every net must
then agree to atol = rtol = 1e-5 (fp32 gradients and Adam steps summed
in another order). Training itself is compared only statistically, on
the contextual bandit of tests/test_core_sac.py: the RNG streams differ.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config.base import ServingConfig as JaxServingConfig
from repro.core.replay import ReplayBuffer as JaxReplay
from repro.core.sac import SACAgent as JaxSAC
from repro.core.sac import SACConfig as JaxSACConfig
from repro.core.utility import utility as jax_utility
from repro_torch.config.base import ServingConfig
from repro_torch.core.networks import MLP, soft_update
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.sac import NETS, SACAgent, SACConfig
from repro_torch.core.utility import scheduling_slot, utility
from repro_torch.models.bridge import sac_nets_from_jax

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    {}, {"batch_sizes": (1, 2, 4, 8), "concurrency_levels": (1,)},
    {"token_budgets": (0, 32, 8), "spec_depths": (0, 2, 4),
     "tp_degrees": (1, 2)}])
def test_serving_config_copy_matches_reference(kw):
    """Field for field the reference's, and every action decodes and
    encodes the same through every codec."""
    ref, cfg = JaxServingConfig(**kw), ServingConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.n_actions == ref.n_actions
    for a in range(cfg.n_actions):
        q = cfg.action_to_quint(a)
        assert q == ref.action_to_quint(a)
        assert cfg.action_to_quad(a) == ref.action_to_quad(a)
        assert cfg.action_to_triple(a) == ref.action_to_triple(a)
        assert cfg.action_to_pair(a) == ref.action_to_pair(a)
        assert cfg.quint_to_action(*q) == a
        assert cfg.quad_to_action(*q[:4]) == ref.quad_to_action(*q[:4])
        assert cfg.pair_to_action(*q[:2]) == ref.pair_to_action(*q[:2])


@pytest.mark.parametrize("kw", [
    {"exec_mode": "batch"}, {"token_budgets": ()}, {"spec_depths": (0, -2)},
    {"spec_accept_rate": 1.5}, {"tp_degrees": (1, 0)},
    {"decode_steps_mean": 0.5}])
def test_serving_config_rejects_out_of_range_values(kw):
    with pytest.raises(ValueError, match="ServingConfig"):
        ServingConfig(**kw)


def test_utility_and_replay_copies_match_reference():
    assert scheduling_slot(1.2, 4) == pytest.approx(0.3)
    for args in ((10.0, 0.05, 1.0, 2), (0.0, 0.0, 0.0, 1), (3.0, 2.0, 0.5,
                                                             4)):
        assert utility(*args) == jax_utility(*args)
    rng = np.random.default_rng(0)
    ours, ref = ReplayBuffer(3, capacity=1500, seed=4), JaxReplay(3, 1500, 4)
    for _ in range(1600):  # past one growth and the capacity wrap
        t = (rng.standard_normal(3), int(rng.integers(5)), rng.random(),
             rng.standard_normal(3), bool(rng.random() < 0.1))
        ours.add(*t)
        ref.add(*t)
    assert len(ours) == len(ref) == 1500
    for _ in range(3):
        a, b = ours.sample(64), ref.sample(64)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_mlp_init_and_soft_update():
    """He-normal weights (the last layer scaled by ``out_scale``), zero
    biases, (in, out) layout; Polyak averaging in place."""
    gen = torch.Generator().manual_seed(0)
    net = MLP(64, 32, out_scale=0.01, generator=gen)
    w = [p.detach() for p in net.w]
    assert [tuple(t.shape) for t in w] == [(64, 128), (128, 64), (64, 32)]
    assert all(not b.any() for b in net.b)
    assert abs(float(w[0].std()) - (2 / 64) ** 0.5) < 0.01
    assert abs(float(w[1].std()) - (2 / 128) ** 0.5) < 0.01
    assert abs(float(w[2].std()) - 0.01 * (2 / 64) ** 0.5) < 2e-4
    assert net(torch.zeros(5, 64)).shape == (5, 32)
    other = MLP(64, 32, generator=gen)
    before = [p.detach().clone() for p in other.parameters()]
    soft_update(other, net, 0.25)
    for t, o, b in zip(other.parameters(), net.parameters(), before):
        torch.testing.assert_close(t, 0.75 * b + 0.25 * o)


def _jax_nets(agent: JaxSAC) -> dict:
    st = agent.state
    nets = {name: getattr(st, name) for name in NETS}
    nets["log_alpha"] = st.log_alpha
    return jax.tree.map(np.asarray, nets)


def test_sac_updates_match_reference():
    """Bridged nets, the same replay contents and draws, three updates:
    losses, alpha, entropy and every net agree."""
    dim, n_act, batch = 6, 8, 32
    jcfg = JaxSACConfig(batch_size=batch)
    ref = JaxSAC(dim, n_act, jcfg, seed=3)
    ours = SACAgent(dim, n_act, SACConfig(**jcfg._asdict()), seed=3,
                    device="cpu")
    ours.load_nets(sac_nets_from_jax(_jax_nets(ref)))
    rng = np.random.default_rng(1)
    for _ in range(3 * batch):
        t = (rng.standard_normal(dim).astype(np.float32),
             int(rng.integers(n_act)), float(rng.standard_normal()),
             rng.standard_normal(dim).astype(np.float32),
             bool(rng.random() < 0.2))
        ref.observe(*t)
        ours.observe(*t)
    for step in range(3):
        want, got = ref.update(), ours.update()
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=TOL,
                                       rtol=TOL, err_msg=f"{key} @ {step}")
    nets = _jax_nets(ref)
    for name in NETS:
        for i, layer in enumerate(nets[name]["layers"]):
            net = getattr(ours, name)
            np.testing.assert_allclose(net.w[i].detach().numpy(),
                                       layer["w"], atol=TOL, rtol=TOL,
                                       err_msg=f"{name} w{i}")
            np.testing.assert_allclose(net.b[i].detach().numpy(),
                                       layer["b"], atol=TOL, rtol=TOL,
                                       err_msg=f"{name} b{i}")
    np.testing.assert_allclose(ours.log_alpha.item(), nets["log_alpha"],
                               atol=TOL, rtol=TOL)
    assert ours.step == 3


def test_sac_waits_for_a_batch_and_clips_the_temperature():
    agent = SACAgent(3, 4, SACConfig(batch_size=8, lr=0.5), device="cpu")
    s = np.zeros(3, np.float32)
    for i in range(7):
        agent.observe(s, i % 4, 1.0, s, False)
        assert agent.update() == {}
    for i in range(50):
        agent.observe(s, i % 4, 1.0, s, False)
        agent.update()
    assert -4.0 <= agent.log_alpha.item() <= 1.5
    assert agent.metrics["alpha"] == pytest.approx(
        agent.log_alpha.exp().item())
    assert 0 <= agent.act(s) < 4 and 0 <= agent.act(s, greedy=True) < 4


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


def test_sac_learns_bandit():
    """Statistical parity with tests/test_core_sac.py: trained on the
    same bandit with the same learning rate, discount and reward scale,
    the port's agent reaches the reference test's greedy-regret bound,
    in a third of its steps at half its mini-batch (the port's agents
    land near 0.03 there)."""
    env = Bandit()
    agent = SACAgent(env.dim, env.n_actions,
                     SACConfig(batch_size=64, lr=3e-3, gamma=0.0,
                               reward_scale=1.0), seed=1, device="cpu")
    s = env.ctx()
    for _ in range(500):
        a = agent.act(s)
        s2 = env.ctx()
        agent.observe(s, a, env.reward(s, a), s2, False)
        agent.update()
        s = s2
    regret = 0.0
    for _ in range(300):
        s = env.ctx()
        a = agent.act(s, greedy=True)
        regret += float(np.max(s @ env.w)) - float(s @ env.w[:, a])
    assert regret / 300 < 0.35
    assert 0 < agent.metrics["alpha"] < 10.0
    assert agent.metrics["entropy"] >= 0.0
