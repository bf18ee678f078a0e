"""Baseline schedulers (paper §V-B); the port of ``repro.core.baselines``.

* ``TACAgent``   — "Triton with Actor-Critic": advantage actor-critic
                   WITHOUT the entropy term (the paper's key ablation).
* ``PPOAgent``   — on-policy clipped-surrogate PPO.
* ``DDQNAgent``  — double deep Q-network, epsilon-greedy.
* ``GAScheduler``— genetic algorithm over the (b, m_c) grid; fitness = U.
* ``EDFScheduler``— DeepRT-style earliest-deadline-first dynamic batching,
                   no concurrency (m_c = 1).
* ``FixedScheduler`` — static (b, m_c) (Triton default configuration).

All expose the common interface: ``act(state) -> action``,
``observe(s, a, r, s2, done)``, ``update() -> metrics``.

The three learning agents keep their nets (``repro_torch.core.networks.MLP``)
on ``device``, default ``"cuda"``, which raises without a GPU; pass
``device="cpu"`` to run on the CPU. Each update keeps the reference's
order and steps ``torch.optim.Adam`` (the reference's ``adam`` math with
its defaults). Sampling draws from a ``torch.Generator`` on the agent's
device seeded with ``seed + 1``, so its values differ from
``jax.random``'s; DDQN's epsilon draws stay on its numpy RNG, as in the
reference. Weights are drawn from ``seed`` with torch's generator;
``load_nets`` carries the reference's across
(``repro_torch.models.bridge``). GA, EDF and Fixed are numpy, as in the
reference.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.paper_edge_models import EdgeModelProfile
from repro_torch.core.networks import MLP, soft_update
from repro_torch.core.replay import ReplayBuffer
from repro_torch.device import resolve_device
from repro_torch.serving import latency_model as lm
from repro_torch.serving.platforms import PLATFORMS


class _NetAgent:
    """What the three learning baselines share: the device, the seeded
    generators, the state-to-tensor boundary and ``load_nets``."""

    #: the agent's nets, by attribute name
    NETS: Tuple[str, ...] = ()

    def _init_device(self, device, seed: int) -> torch.Generator:
        """Resolve ``device``; seed the sampling generator with ``seed + 1``
        and return the weights' generator, seeded with ``seed``."""
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def load_nets(self, nets: Dict) -> None:
        """Replace every net in ``NETS`` with the state dicts in ``nets``
        (see ``repro_torch.models.bridge``); optimizer states are left as
        they are."""
        for name in self.NETS:
            getattr(self, name).load_state_dict(nets[name])

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _sample(self, logits: torch.Tensor) -> int:
        return int(torch.multinomial(torch.softmax(logits, -1), 1,
                                     generator=self._gen))

    def _batch(self, replay: ReplayBuffer, n: int) -> Dict[str, torch.Tensor]:
        b = {k: torch.from_numpy(v).to(self.device)
             for k, v in replay.sample(n).items()}
        b["a"] = b["a"].long()
        return b


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def _logp_of(policy: MLP, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """log pi(a | s) per row."""
    return torch.log_softmax(policy(s), -1).gather(1, a[:, None])[:, 0]


# =====================================================================
# TAC — actor-critic without entropy
# =====================================================================
class TACAgent(_NetAgent):
    name = "tac"
    learns = True
    NETS = ("policy", "value")

    def __init__(self, state_dim: int, n_actions: int, lr: float = 1e-3,
                 gamma: float = 0.9, batch_size: int = 512, seed: int = 0,
                 device="cuda"):
        gen = self._init_device(device, seed)
        self.policy = MLP(state_dim, n_actions, generator=gen,
                          device=self.device)
        self.value = MLP(state_dim, 1, generator=gen, device=self.device)
        self.opt_p = torch.optim.Adam(self.policy.parameters(), lr=lr)
        self.opt_v = torch.optim.Adam(self.value.parameters(), lr=lr)
        self.replay = ReplayBuffer(state_dim, 100_000, seed)
        self.lr, self.gamma, self.batch_size = lr, gamma, batch_size
        self.metrics: Dict[str, float] = {}

    @torch.no_grad()
    def act(self, s, greedy: bool = False) -> int:
        logits = self.policy(self._tensor(s))
        if greedy:
            return int(torch.argmax(logits))
        return self._sample(logits)

    def observe(self, s, a, r, s2, done):
        self.replay.add(s, a, r, s2, done)

    def update(self):
        if len(self.replay) < self.batch_size:
            return {}
        b = self._batch(self.replay, self.batch_size)
        s, a = b["s"], b["a"]
        # both losses against the nets before this update, as the
        # reference's one jitted step
        with torch.no_grad():
            target = b["r"] + self.gamma * (1 - b["done"]) \
                * self.value(b["s2"])[:, 0]
            adv = target - self.value(s)[:, 0]
        lv = (self.value(s)[:, 0] - target).square().mean()
        lp = -(_logp_of(self.policy, s, a) * adv).mean()  # no entropy bonus
        _step(self.opt_v, lv)
        _step(self.opt_p, lp)
        self.metrics = {"critic_loss": lv.item(), "actor_loss": lp.item()}
        return self.metrics


# =====================================================================
# PPO
# =====================================================================
class PPOAgent(_NetAgent):
    name = "ppo"
    learns = True
    NETS = ("policy", "value")

    def __init__(self, state_dim: int, n_actions: int, lr: float = 1e-3,
                 gamma: float = 0.9, lam: float = 0.95, clip: float = 0.2,
                 horizon: int = 256, epochs: int = 4, seed: int = 0,
                 device="cuda"):
        gen = self._init_device(device, seed)
        self.policy = MLP(state_dim, n_actions, generator=gen,
                          device=self.device)
        self.value = MLP(state_dim, 1, generator=gen, device=self.device)
        self.opt_p = torch.optim.Adam(self.policy.parameters(), lr=lr)
        self.opt_v = torch.optim.Adam(self.value.parameters(), lr=lr)
        self.lr, self.gamma, self.lam = lr, gamma, lam
        self.clip, self.horizon, self.epochs = clip, horizon, epochs
        self.buf: List[Tuple] = []
        self.metrics: Dict[str, float] = {}

    @torch.no_grad()
    def act(self, s, greedy: bool = False) -> int:
        logits = self.policy(self._tensor(s))
        if greedy:
            return int(torch.argmax(logits))
        a = self._sample(logits)
        self._last_logp = float(torch.log_softmax(logits, -1)[a])
        return a

    @torch.no_grad()
    def observe(self, s, a, r, s2, done):
        v = float(self.value(self._tensor(s))[0])
        self.buf.append((s, a, r, getattr(self, "_last_logp", 0.0), v,
                         float(done)))

    def update(self):
        if len(self.buf) < self.horizon:
            return {}
        s = np.array([t[0] for t in self.buf], np.float32)
        a = np.array([t[1] for t in self.buf], np.int32)
        r = np.array([t[2] for t in self.buf], np.float32)
        logp = np.array([t[3] for t in self.buf], np.float32)
        v = np.array([t[4] for t in self.buf], np.float32)
        done = np.array([t[5] for t in self.buf], np.float32)
        # GAE
        adv = np.zeros_like(r)
        last = 0.0
        next_v = np.append(v[1:], v[-1])
        for t in reversed(range(len(r))):
            delta = r[t] + self.gamma * (1 - done[t]) * next_v[t] - v[t]
            last = delta + self.gamma * self.lam * (1 - done[t]) * last
            adv[t] = last
        ret = adv + v
        batch = {"s": self._tensor(s),
                 "a": torch.as_tensor(a, device=self.device).long(),
                 "logp": self._tensor(logp), "adv": self._tensor(adv),
                 "ret": self._tensor(ret)}
        for _ in range(self.epochs):
            m = self._epoch(batch)
        self.buf.clear()
        self.metrics = {k: float(v) for k, v in m.items()}
        return self.metrics

    def _epoch(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One clipped-surrogate step of the policy and one regression
        step of the value net, both from the nets before the step."""
        adv = b["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        ratio = torch.exp(_logp_of(self.policy, b["s"], b["a"]) - b["logp"])
        lp = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv).mean()
        lv = (self.value(b["s"])[:, 0] - b["ret"]).square().mean()
        _step(self.opt_p, lp)
        _step(self.opt_v, lv)
        return {"actor_loss": lp.detach(), "critic_loss": lv.detach()}


# =====================================================================
# DDQN
# =====================================================================
class DDQNAgent(_NetAgent):
    name = "ddqn"
    learns = True
    NETS = ("q", "q_target")

    def __init__(self, state_dim: int, n_actions: int, lr: float = 1e-3,
                 gamma: float = 0.9, tau: float = 0.005,
                 batch_size: int = 512, eps_decay: float = 3e-4,
                 seed: int = 0, device="cuda"):
        gen = self._init_device(device, seed)
        self.q = MLP(state_dim, n_actions, generator=gen, device=self.device)
        self.q_target = copy.deepcopy(self.q).requires_grad_(False)
        self.opt = torch.optim.Adam(self.q.parameters(), lr=lr)
        self.replay = ReplayBuffer(state_dim, 100_000, seed)
        self.lr, self.gamma, self.tau = lr, gamma, tau
        self.batch_size, self.eps_decay = batch_size, eps_decay
        self.n_actions = n_actions
        self.steps = 0
        self.np_rng = np.random.default_rng(seed)
        self.metrics: Dict[str, float] = {}

    @property
    def epsilon(self) -> float:
        return max(0.05, 1.0 - self.eps_decay * self.steps)

    @torch.no_grad()
    def act(self, s, greedy: bool = False) -> int:
        self.steps += 1
        if not greedy and self.np_rng.random() < self.epsilon:
            return int(self.np_rng.integers(self.n_actions))
        return int(torch.argmax(self.q(self._tensor(s))))

    def observe(self, s, a, r, s2, done):
        self.replay.add(s, a, r, s2, done)

    def update(self):
        if len(self.replay) < self.batch_size:
            return {}
        b = self._batch(self.replay, self.batch_size)
        # double-Q: argmax under the online net, value under the target net
        with torch.no_grad():
            a2 = torch.argmax(self.q(b["s2"]), -1)
            q2 = self.q_target(b["s2"]).gather(1, a2[:, None])[:, 0]
            target = b["r"] + self.gamma * (1 - b["done"]) * q2
        q = self.q(b["s"]).gather(1, b["a"][:, None])[:, 0]
        loss = (q - target).square().mean()
        _step(self.opt, loss)
        soft_update(self.q_target, self.q, self.tau)
        self.metrics = {"critic_loss": loss.item()}
        return self.metrics


# =====================================================================
# GA — heuristic baseline
# =====================================================================
class GAScheduler:
    """Evolves a population of actions; fitness = observed utility.
    Ignores the state (the paper's GA port optimises a static config)."""

    name = "ga"
    learns = True

    def __init__(self, state_dim: int, n_actions: int, pop: int = 24,
                 mut_p: float = 0.15, seed: int = 0):
        self.n_actions = n_actions
        self.rng = np.random.default_rng(seed)
        self.pop = self.rng.integers(0, n_actions, size=pop)
        self.fitness = np.full(pop, -np.inf)
        self.cursor = 0
        self.mut_p = mut_p
        self.metrics: Dict[str, float] = {}

    def act(self, s, greedy: bool = False) -> int:
        if greedy:
            return int(self.pop[int(np.argmax(self.fitness))])
        return int(self.pop[self.cursor])

    def observe(self, s, a, r, s2, done):
        # running average fitness of the individual just evaluated
        f = self.fitness[self.cursor]
        self.fitness[self.cursor] = r if not np.isfinite(f) else 0.8 * f + 0.2 * r
        self.cursor = (self.cursor + 1) % len(self.pop)

    def update(self):
        if self.cursor != 0 or not np.isfinite(self.fitness).all():
            return {}
        # generation step: tournament selection + crossover + mutation
        n = len(self.pop)
        order = np.argsort(-self.fitness)
        elite = self.pop[order[: n // 4]]
        children = []
        while len(children) < n - len(elite):
            pa, pb = self.rng.choice(elite, 2)
            child = pa if self.rng.random() < 0.5 else pb
            if self.rng.random() < self.mut_p:
                child = int(self.rng.integers(self.n_actions))
            children.append(child)
        self.pop = np.concatenate([elite, np.array(children, dtype=int)])
        best = float(np.max(self.fitness))
        self.fitness = np.full(n, -np.inf)
        self.metrics = {"best_fitness": best,
                        "critic_loss": -best}  # convergence proxy
        return self.metrics


# =====================================================================
# EDF (DeepRT) and Fixed
# =====================================================================
class EDFScheduler:
    """DeepRT [12]: soft real-time EDF dynamic batching.

    Picks the LARGEST batch whose estimated completion (offline
    single-tenant latency profile + expected fill wait) still meets the
    earliest deadline; never runs concurrent instances and has NO
    interference prediction, so its feasibility estimates are
    single-tenant-optimistic and break under multi-tenant contention.

    Decodes queue length / age / SLO / model compute from the featurized
    state (layout in serving/features.py).
    """

    name = "edf"
    learns = False

    def __init__(self, batch_sizes, concurrency_levels, queue_feature: int,
                 n_models: int = 6, arrival_rps: float = 30.0,
                 platform: str = "xavier_nx", **_):
        self.batch_sizes = list(batch_sizes)
        self.queue_feature = queue_feature
        self.n_models = n_models
        self.arrival_rps = arrival_rps
        self.hw = PLATFORMS[platform]

    def act(self, s, greedy: bool = False) -> int:
        qlen = max(1.0, float(np.expm1(s[self.queue_feature])))
        slo_ms = float(s[self.n_models]) * 100.0
        gflops = float(np.expm1(s[self.n_models + 1]))
        age_ratio = float(np.expm1(s[self.queue_feature + 1]))
        slack_ms = max(slo_ms * (1.0 - age_ratio), 2.0)
        prof = EdgeModelProfile("x", "x", "x", (3, 224, 224), slo_ms,
                                gflops, 10.0, 12.0)
        pick = self.batch_sizes[0]
        for b in sorted(self.batch_sizes, reverse=True):
            fill_wait = max(0.0, b - qlen) * 1000.0 / self.arrival_rps
            est = lm.estimate_execution(self.hw, prof, b, 1)  # single-tenant
            if fill_wait + est.total_ms <= slack_ms:
                pick = b
                break
        return self.batch_sizes.index(pick)  # m_c index 0 => m_c = 1

    def observe(self, *a):
        pass

    def update(self):
        return {}


class FixedScheduler:
    name = "fixed"
    learns = False

    def __init__(self, action: int, **_):
        self.action = action

    def act(self, s, greedy: bool = False) -> int:
        return self.action

    def observe(self, *a):
        pass

    def update(self):
        return {}
