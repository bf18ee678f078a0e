"""Discrete Soft Actor-Critic scheduler (paper §IV-B, Algorithm 1); the
port of ``repro.core.sac`` to ``torch.nn`` and ``torch.optim``.

Maximum-entropy objective (Eq. 5): maximise Σ γ^t [r + α H(π(·|s))].

* twin soft-Q critics + target copies, min-of-two to curb overestimation;
* soft state value (Eq. 8):  V(s) = π(s)ᵀ [Q(s) − α log π(s)];
* critic loss = soft Bellman residual (Eq. 9);
* actor loss = KL-projection surrogate (Eq. 11):
      J_π = E_s [ π(s)ᵀ (α log π(s) − Q(s)) ];
* automatic temperature (Eq. 12) against a target entropy H̄.

One update keeps the reference's order: the critics step first, then the
actor against the UPDATED critics, then the temperature against the
UPDATED policy, then the Polyak target sync. Adam is ``torch.optim.Adam``
(the reference's ``adam`` math with its defaults; the parity test holds
the two to 1e-5 over three updates).
"""
from __future__ import annotations

import copy
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.networks import MLP, soft_update
from repro_torch.core.replay import ReplayBuffer
from repro_torch.device import resolve_device

#: the nets of an agent, in the reference's ``SACState`` order
NETS = ("policy", "q1", "q2", "q1_target", "q2_target")


class SACConfig(NamedTuple):
    gamma: float = 0.9
    tau: float = 0.005
    lr: float = 1e-3          # paper: Adam, lr 1e-3
    batch_size: int = 512     # paper: mini-batch 512
    reward_scale: float = 0.25
    target_entropy_scale: float = 0.25
    update_every: int = 1


def _policy_dist(policy: MLP, s: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    logp = torch.log_softmax(policy(s), dim=-1)
    return logp.exp(), logp


class SACAgent:
    """Online wrapper: replay + act/observe/update, numpy at the boundary.

    Runs on ``device`` (default ``"cuda"``, which raises without a GPU;
    pass ``device="cpu"`` to run on the CPU). ``act`` reads one action
    back to the host, a device synchronisation per call."""

    name = "sac"
    learns = True

    def __init__(self, state_dim: int, n_actions: int,
                 cfg: SACConfig = SACConfig(), seed: int = 0,
                 buffer_size: int = 1_000_000, device="cuda"):
        self.cfg = cfg
        self.n_actions = n_actions
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        # small policy head => near-uniform initial policy (max entropy)
        self.policy = MLP(state_dim, n_actions, out_scale=0.01,
                          generator=gen, device=self.device)
        self.q1 = MLP(state_dim, n_actions, generator=gen, device=self.device)
        self.q2 = MLP(state_dim, n_actions, generator=gen, device=self.device)
        self.q1_target = copy.deepcopy(self.q1).requires_grad_(False)
        self.q2_target = copy.deepcopy(self.q2).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=self.device,
                                     requires_grad=True)
        self._opts = {
            "policy": torch.optim.Adam(self.policy.parameters(), lr=cfg.lr),
            "q1": torch.optim.Adam(self.q1.parameters(), lr=cfg.lr),
            "q2": torch.optim.Adam(self.q2.parameters(), lr=cfg.lr),
            "alpha": torch.optim.Adam([self.log_alpha], lr=cfg.lr),
        }
        self.replay = ReplayBuffer(state_dim, buffer_size, seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self.step = 0
        self.metrics: Dict[str, float] = {}

    def load_nets(self, nets: Dict) -> None:
        """Replace the nets and ``log_alpha`` with ``nets`` (see
        ``repro_torch.models.bridge.sac_nets_from_jax``); the optimizer
        states are left as they are."""
        for name in NETS:
            getattr(self, name).load_state_dict(nets[name])
        with torch.no_grad():
            self.log_alpha.copy_(nets["log_alpha"])

    @torch.no_grad()
    def act(self, s: np.ndarray, greedy: bool = False) -> int:
        logits = self.policy(torch.as_tensor(s, dtype=torch.float32,
                                             device=self.device))
        if greedy:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._gen))

    def observe(self, s, a, r, s2, done) -> None:
        self.replay.add(s, a, r, s2, done)

    def update(self) -> Dict[str, float]:
        """One SAC update on a replay mini-batch once the buffer holds a
        batch; returns its metrics (empty before that)."""
        if len(self.replay) < self.cfg.batch_size:
            return {}
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in
                 self.replay.sample(self.cfg.batch_size).items()}
        m = self._update(batch)
        self.metrics = {k: float(v) for k, v in m.items()}
        return self.metrics

    def _step(self, opt: str, loss: torch.Tensor) -> None:
        self._opts[opt].zero_grad(set_to_none=True)
        loss.backward()
        self._opts[opt].step()

    def _update(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        s, a, s2, done = b["s"], b["a"].long(), b["s2"], b["done"]
        r = b["r"] * cfg.reward_scale
        alpha = self.log_alpha.detach().exp()
        target_entropy = cfg.target_entropy_scale * math.log(
            float(self.n_actions))

        # ---- critic update (Eq. 7-9) -------------------------------------
        with torch.no_grad():
            pi2, logp2 = _policy_dist(self.policy, s2)
            q_t = torch.minimum(self.q1_target(s2), self.q2_target(s2))
            v2 = (pi2 * (q_t - alpha * logp2)).sum(-1)
            target = r + cfg.gamma * (1.0 - done) * v2  # (B,)
        critic = []
        for name in ("q1", "q2"):
            qa = getattr(self, name)(s).gather(1, a[:, None])[:, 0]
            loss = 0.5 * (qa - target).square().mean()
            self._step(name, loss)
            critic.append(loss.detach())

        # ---- actor update (Eq. 11), against the updated critics ----------
        with torch.no_grad():
            q_min = torch.minimum(self.q1(s), self.q2(s))
        pi, logp = _policy_dist(self.policy, s)
        actor = (pi * (alpha * logp - q_min)).sum(-1).mean()
        self._step("policy", actor)

        # ---- temperature update (Eq. 12), against the updated policy -----
        with torch.no_grad():
            pi, logp = _policy_dist(self.policy, s)
            entropy = -(pi * logp).sum(-1)
        alpha_loss = (self.log_alpha.exp() * (entropy - target_entropy)).mean()
        self._step("alpha", alpha_loss)
        with torch.no_grad():
            self.log_alpha.clamp_(-4.0, 1.5)

        # ---- target sync ----------------------------------------------------
        soft_update(self.q1_target, self.q1, cfg.tau)
        soft_update(self.q2_target, self.q2, cfg.tau)
        self.step += 1
        return {"critic_loss": 0.5 * (critic[0] + critic[1]),
                "actor_loss": actor.detach(),
                "alpha": self.log_alpha.detach().exp(),
                "entropy": entropy.mean(), "alpha_loss": alpha_loss.detach()}
