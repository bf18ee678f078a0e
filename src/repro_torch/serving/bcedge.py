"""BCEdge framework facade (paper Fig. 2: agent + SLO guard): the port of
``repro.serving.bcedge``.

The learning-based scheduler picks (b, m_c); before dispatch, the
SLO-aware interference predictor estimates the round latency, and if it
exceeds the scheduling-slot budget (Eq. 1) or memory capacity, the guard
degrades the action to the nearest feasible (b, m_c) (paper §IV-F).

Two drivers live here:

* ``BCEdgeScheduler`` + ``run_episode`` — the simulator path (paper
  experiments, Figs. 7-16). The simulator is numpy on the host; the agent
  and the predictor run on their own device (the GPU by default), and
  each ``act`` and each guard ``predict`` reads one value back from it, a
  device synchronisation per call.
* ``PoolScheduler`` — the real runtime path: one discrete SAC agent per
  model picks (b, m_c, token budget, speculation depth, TP degree) over
  the instance pool; b caps the active slots per instance, m_c is applied
  through ``pool.scale_to`` so the action really spawns or drains engine
  instances, the token budget caps each iteration's prefill + decode
  tokens, the depth is each instance's live ``spec_k`` and the degree the
  devices each new instance spans (``pool.set_tp_degree``). Its guard
  checks an action against the models the pool calibrates from its own
  measured iterations (contention, token cost per degree with the verify
  surcharge and the analytic collective surcharge
  ``tp_collective_ms_per_token``, KV occupancy) and the pool's device
  set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.core.interference import NNInterferencePredictor
from repro_torch.launch.roofline import LINK_BW
from repro_torch.serving import latency_model as lm
from repro_torch.serving.simulator import EdgeServingEnv


@dataclasses.dataclass
class EpisodeResult:
    """Aggregated outcome of one serving episode (the quantities the
    paper's Figs. 7-16 are computed from)."""
    summary: Dict[str, float]
    rewards: List[float]
    losses: List[float]
    overhead_ms: List[float]
    per_model_utility: Dict[str, float]
    per_model_throughput: Dict[str, float]
    per_model_latency: Dict[str, float]
    timeline: List[Dict]


class BCEdgeScheduler:
    """Agent + SLO guard, the paper's Fig.-2 scheduler block (§IV-B with
    the §IV-F predictor guard; continuous-mode reinterpretation in
    docs/ARCHITECTURE.md §7)."""

    def __init__(self, env: EdgeServingEnv, agent,
                 predictor: Optional[NNInterferencePredictor] = None,
                 guard: bool = True):
        self.env = env
        self.agent = agent
        self.predictor = predictor
        self.guard = guard and predictor is not None
        self.guard_interventions = 0

    # ---- SLO guard --------------------------------------------------------
    def _feasible(self, model: str, b: int, m_c: int) -> bool:
        """Deadline feasibility: the predicted round latency (plus the
        batch-formation wait still ahead) must fit the OLDEST queued
        request's remaining SLO budget — the paper's predictor-guided
        robustness mechanism (§IV-F).

        Under exec_mode="continuous" the predictor is trained on
        PER-ITERATION latency (see ``run_episode``), so Eq.-1 feasibility
        is checked per iteration: one predicted iteration must fit the
        per-iteration share of the budget, i.e. the remaining SLO budget
        divided by the expected decode length of a request."""
        q = self.env.queues[model]
        cfg = self.env.cfg
        prof = EDGE_MODELS[model]
        slo = prof.slo_ms * cfg.slo_scale
        age = q.peek_oldest_age(self.env.now)
        fill_wait = max(0.0, b - len(q)) * 1000.0 / \
            max(cfg.arrival_rps, 1e-3)
        budget_ms = max(slo - age - fill_wait, 2.0)
        if cfg.exec_mode == "continuous":
            budget_ms /= max(cfg.decode_steps_mean, 1.0)
        feats = self.env.predict_features(model, b, m_c)
        pred_lat_ms = self.predictor.predict(feats) * 1000.0
        _, other_mem = self.env._other_load(exclude=model)
        mem = m_c * lm.instance_memory_gb(prof, b) + other_mem
        return pred_lat_ms <= budget_ms and mem <= self.env.hw.mem_gb

    def select_action(self, state: np.ndarray, model: str) -> int:
        a = self.agent.act(state)
        if not self.guard:
            return a
        # under backlog (oldest request already deep into its SLO) the
        # guard steps aside: throughput is the only way out, and degrading
        # to smaller rounds would death-spiral the queue
        q = self.env.queues[model]
        prof = EDGE_MODELS[model]
        if q.peek_oldest_age(self.env.now) >= 0.5 * prof.slo_ms * \
                self.env.cfg.slo_scale:
            return a
        cfg = self.env.cfg
        b, m_c = cfg.action_to_pair(a)
        if self._feasible(model, b, m_c):
            return a
        # degrade toward feasibility: shrink batch first, then concurrency
        self.guard_interventions += 1
        bs, ms = list(cfg.batch_sizes), list(cfg.concurrency_levels)
        bi, mi = bs.index(b), ms.index(m_c)
        while bi > 0 or mi > 0:
            if bi > 0:
                bi -= 1
            elif mi > 0:
                mi -= 1
            if self._feasible(model, bs[bi], ms[mi]):
                break
        return cfg.pair_to_action(bs[bi], ms[mi])


def run_episode(env: EdgeServingEnv, agent,
                predictor: Optional[NNInterferencePredictor] = None,
                guard: bool = True, learn: bool = True,
                update_every: int = 1, max_steps: int = 100_000
                ) -> EpisodeResult:
    sched = BCEdgeScheduler(env, agent, predictor, guard)
    s = env.reset()
    rewards: List[float] = []
    losses: List[float] = []
    overheads: List[float] = []
    timeline: List[Dict] = []
    done, steps = False, 0
    seen_rounds = 0
    while not done and steps < max_steps:
        model = env._focus
        t0 = time.perf_counter()
        a = sched.select_action(s, model)
        s2, r, done, info = env.step(a)
        if learn:
            for (ts, ta, tr, ts2, tdone) in info["transitions"]:
                agent.observe(ts, ta, tr, ts2, tdone)
            if steps % update_every == 0:
                m = agent.update()
                if m and "critic_loss" in m:
                    losses.append(m["critic_loss"])
        overheads.append((time.perf_counter() - t0) * 1000.0)
        # feed the predictor every newly completed round
        new_rounds = env.history[seen_rounds:]
        seen_rounds = len(env.history)
        for rnd in new_rounds:
            rewards.append(rnd.utility)
            timeline.append({"t_ms": rnd.finish_ms, "model": rnd.model,
                             "reward": rnd.utility, "b": rnd.b,
                             "m_c": rnd.m_c, "n": rnd.n_requests,
                             "violations": rnd.violations})
            if predictor is not None and rnd.features is not None:
                # round mode: the target is the round latency; continuous
                # mode: the PER-ITERATION latency (the guard checks Eq.-1
                # feasibility per iteration, see _feasible)
                actual_s = max(rnd.finish_ms - rnd.start_ms, 1e-3) / 1000.0
                if rnd.exec_mode == "continuous":
                    actual_s /= max(rnd.n_iters, 1)
                predictor.observe(rnd.features, actual_s)
        s = s2
        steps += 1

    # per-model aggregates
    per_u: Dict[str, List[float]] = {}
    per_thr: Dict[str, float] = {}
    per_lat: Dict[str, List[float]] = {}
    for rnd in env.history:
        per_u.setdefault(rnd.model, []).append(rnd.utility)
        per_thr[rnd.model] = per_thr.get(rnd.model, 0.0) + rnd.n_requests
        per_lat.setdefault(rnd.model, []).extend(rnd.latencies_ms)
    dur_s = max(env.now, 1.0) / 1000.0
    return EpisodeResult(
        summary=env.summarize(),
        rewards=rewards,
        losses=losses,
        overhead_ms=overheads,
        per_model_utility={m: float(np.mean(v)) for m, v in per_u.items()},
        per_model_throughput={m: v / dur_s for m, v in per_thr.items()},
        per_model_latency={m: float(np.mean(v)) for m, v in per_lat.items()},
        timeline=timeline,
    )


#: state vector fed to the per-model pool agents (docs/RUNTIME.md):
#: [log1p(queue), oldest slack s, own m_c share, total live share,
#:  log1p(predicted iter ms), log1p(Eq.-1 slot ms),
#:  KV budget headroom frac (1.0 for dense/unlimited pools),
#:  log1p(prefill backlog tokens), log1p(preemptions since last decision),
#:  prefix-cache hit rate (0 for dense or cache-off pools), speculative
#:  acceptance rate, shared-device-set utilization (0 for a pool without
#:  ``n_devices``), host-tier occupancy frac]
POOL_STATE_DIM = 13

#: bytes of one element of the all-reduced activations: the port serves
#: fp32 (the reference prices bf16's 2)
TP_PAYLOAD_BYTES = 4


def tp_collective_ms_per_token(model_cfg, tp_degree: int) -> float:
    """Analytic per-token collective surcharge at TP degree ``d``: each
    layer all-reduces its (d_model,) residual twice per token (after the
    row-split ``wo`` and ``w_down``), and a ring all-reduce moves
    ``2(d-1)/d`` of the payload per device, priced at the link bandwidth
    ``launch.roofline.LINK_BW`` (NVLink 4's data-sheet figure, not
    measured; the reference prices a TPU's ICI). The guard adds it to the
    measured per-degree token-cost fit, so a degree with no samples yet is
    still priced."""
    if tp_degree <= 1:
        return 0.0
    bytes_per_chip = model_cfg.n_layers * 2 \
        * 2.0 * (tp_degree - 1) / tp_degree * model_cfg.d_model \
        * TP_PAYLOAD_BYTES
    return bytes_per_chip / LINK_BW * 1000.0


class PoolScheduler:
    """(b, m_c) scheduler over a REAL ``ModelInstancePool``: b caps the
    active slots per instance, m_c is applied through ``pool.scale_to``,
    and the token budget, speculation depth and TP degree
    (``cfg.token_budgets``, ``cfg.spec_depths``, ``cfg.tp_degrees``) are
    the third, fourth and fifth axes. One agent per model (the port's
    ``SACAgent`` on the pool's device unless ``agents`` are given); the
    SLO guard degrades infeasible actions, speculation first, using the
    contention and token-cost models the pool calibrates from its own
    measured iteration latencies and the pool's device set."""

    def __init__(self, pool, cfg: ServingConfig,
                 slo_ms: Optional[Dict[str, float]] = None,
                 decode_steps_mean: float = 8.0, guard: bool = True,
                 learn: bool = True, seed: int = 0, agents=None):
        self.pool = pool
        self.cfg = cfg
        self.slo_ms = dict(slo_ms or {})
        self.decode_steps_mean = max(1.0, decode_steps_mean)
        self.guard = guard
        self.learn = learn
        self.guard_interventions = 0
        if agents is None:
            from repro_torch.core.sac import SACAgent, SACConfig
            agents = {m: SACAgent(POOL_STATE_DIM, cfg.n_actions,
                                  SACConfig(batch_size=32, lr=1e-3),
                                  seed=seed + i, device=pool.device)
                      for i, m in enumerate(pool.configs)}
        self.agents = agents
        self._last: Dict[str, tuple] = {}      # model -> (state, action)
        self._since: Dict[str, list] = {m: [] for m in pool.configs}
        #: per-model preemption counter at the last decision (the state
        #: vector feeds the delta)
        self._preempt_seen: Dict[str, int] = {m: 0 for m in pool.configs}
        #: results already harvested from pool history by ``tick()``
        self._tick_seen: Dict[str, int] = {m: 0 for m in pool.configs}

    # ---- feedback --------------------------------------------------------
    def record(self, results) -> None:
        """Feed finished PoolResults back (call after every pool.step)."""
        for r in results:
            self._since[r.model].append(r)

    def _reward(self, model: str) -> float:
        """Mean per-request Eq.-3 utility since the last decision, with
        the simulator's Eq.-4 violation penalty."""
        rs = self._since[model]
        self._since[model] = []
        if not rs:
            return 0.0
        served = [r.utility for r in rs if not r.rejected]
        u = float(np.mean(served)) if served else 0.0
        return u - 3.5 * sum(r.violated for r in rs) / len(rs)

    # ---- state / guard ---------------------------------------------------
    def _state(self, model: str) -> np.ndarray:
        p = self.pool
        t1, c = p.contention()
        pred = lm.predicted_iter_ms(t1, c, max(1, p.total_live()))
        slack = min(p.oldest_slack_ms(model), 10_000.0)
        occ = p.kv_occupancy()
        headroom = 1.0
        if occ["budget_tokens"] > 0.0:
            # the budget is consumed by live token residency AND by
            # committed spawn grants: report the tighter of the two
            committed = occ["committed_blocks"] * p.block_size
            headroom = max(0.0, 1.0 - max(occ["used_tokens"], committed)
                           / occ["budget_tokens"])
        preempts = p.preempts_by_model.get(model, 0)
        new_preempts = preempts - self._preempt_seen.get(model, 0)
        self._preempt_seen[model] = preempts
        return np.array([
            np.log1p(p.queue_len(model)),
            slack / 1000.0,
            p.m_c(model) / max(1, p.max_instances),
            p.total_live() / max(1, p.max_instances),
            np.log1p(max(pred, 0.0)),
            np.log1p(max(p.slot_ms(model), 0.0)),
            headroom,
            np.log1p(max(0, p.prefill_backlog_tokens(model))),
            np.log1p(max(0, new_preempts)),
            float(occ.get("prefix_hit_rate", 0.0)),
            min(1.0, max(0.0, float(p.spec_accept_rate()))),
            min(1.0, p.devices_in_use() / p.n_devices)
            if p.n_devices else 0.0,
            min(1.0, max(0.0, float(occ.get("host_frac", 0.0)))),
        ], np.float32)

    def _kv_feasible(self, model: str, b: int, m_c: int) -> bool:
        """Eq.-4 (memory) feasibility against the pool's real shared KV
        block budget: b slots x m_c instances at the MEASURED tokens per
        sequence, plus what the other tenants occupy, must fit. Dense
        pools, unlimited budgets and uncalibrated occupancy are feasible.
        The allocation side (committed grants) is enforced by
        ``pool.scale_to`` clamping on free blocks."""
        occ = self.pool.kv_occupancy()
        budget = occ["budget_tokens"]
        tps = occ["tokens_per_seq"]
        if budget <= 0.0 or tps <= 0.0:
            return True
        used_others = occ["used_tokens"] - self.pool.kv_used_tokens(model)
        need = lm.predicted_kv_tokens(tps, b * m_c)
        shared = min(max(occ.get("shared_frac", 0.0), 0.0), 0.95)
        need *= 1.0 - shared
        return need + used_others <= budget

    def _iter_budget_ms(self, model: str) -> float:
        """Per-iteration share of the most urgent request's slack."""
        slack = self.pool.oldest_slack_ms(model)
        if slack == float("inf"):
            slack = self.slo_ms.get(model, 1000.0)
        return max(slack, 2.0) / self.decode_steps_mean

    def _feasible(self, model: str, b: int, m_c: int,
                  token_budget: int = 0, spec_k: int = 0,
                  tp_degree: int = 1) -> bool:
        """Eq.-1 feasibility per iteration at the PROPOSED overlap: the
        calibrated contention model's pool-iteration latency at the other
        models' busy instances plus ``m_c`` must fit the most urgent
        request's per-iteration budget, and so must an iteration of
        ``token_budget`` tokens under the token-cost fit (when nonzero).
        A nonzero ``spec_k`` adds the verify surcharge: every decoding
        slot processes ``1 + k`` tokens, so ``k * b`` more tokens are
        priced on top of the budget (or of the ``b``-token decode floor
        without one). b enters through the KV guard
        (``_kv_feasible``).

        ``tp_degree`` prices the layout: the other models' devices plus
        ``m_c * tp_degree`` must fit the pool's device set, and the
        iteration's work (at least the ``b``-token decode floor) is priced
        through that degree's token-cost fit plus the collective surcharge
        (``tp_collective_ms_per_token``)."""
        if not self._kv_feasible(model, b, m_c):
            return False
        n_dev = self.pool.n_devices
        if n_dev:
            dev_others = sum(i.tp_degree for i in self.pool.live()
                             if i.model != model)
            if dev_others + m_c * tp_degree > n_dev:
                return False
        budget = self._iter_budget_ms(model)
        t1, c = self.pool.contention()
        if t1 > 0.0:
            busy_others = self.pool.busy_count() - sum(
                1 for i in self.pool.live(model) if i.n_resident > 0)
            if lm.predicted_iter_ms(t1, c, max(1, busy_others + m_c)) \
                    > budget:
                return False
        work = token_budget
        if spec_k > 0:
            work = (token_budget if token_budget > 0 else b) + spec_k * b
        if tp_degree > 1 and work == 0:
            work = b  # decode floor: the collective surcharge is per token
        if work > 0:
            base, per_tok = self.pool.token_cost(tp_degree) \
                if tp_degree > 1 else self.pool.token_cost()
            per_tok += tp_collective_ms_per_token(
                self.pool.configs[model], tp_degree)
            if per_tok > 0.0 and lm.predicted_token_iter_ms(
                    base, per_tok, work) > budget:
                return False
        return True

    def _apply(self, model: str, a: int) -> int:
        cfg = self.cfg
        b, m_c, tb, sk, tp = cfg.action_to_quint(a)
        # under backlog the guard steps aside (only throughput clears an
        # old queue)
        slo = self.slo_ms.get(model, 1000.0)
        backlog = self.pool.oldest_slack_ms(model) < 0.5 * slo
        if self.guard and not backlog and \
                not self._feasible(model, b, m_c, tb, sk, tp):
            self.guard_interventions += 1
            bs_levels = list(cfg.batch_sizes)
            ms = list(cfg.concurrency_levels)
            # token budgets ordered most -> least iteration work (0 =
            # uncapped first); degrading walks toward tighter caps
            tbs = sorted(cfg.token_budgets,
                         key=lambda t: float("inf") if t == 0 else t,
                         reverse=True)
            # speculation depths deepest first: walking on sheds the
            # verify surcharge until k is 0
            ks = sorted(cfg.spec_depths, reverse=True)
            # TP degrees widest first: stepping down sheds the collective
            # surcharge and frees m_c * (the step) devices
            tps = sorted(cfg.tp_degrees, reverse=True)
            bi, mi = bs_levels.index(b), ms.index(m_c)
            ti, ki, di = tbs.index(tb), ks.index(sk), tps.index(tp)
            # degrade speculation first (pure surcharge: dropping it sheds
            # no capacity), then the token budget (a tighter cap bounds
            # the iteration), then the TP degree (collectives and devices
            # go, per-instance KV capacity shrinks), then concurrency (it
            # contends and multiplies KV residency), then batch
            while ki < len(ks) - 1 or ti < len(tbs) - 1 \
                    or di < len(tps) - 1 or mi > 0 or bi > 0:
                if ki < len(ks) - 1:
                    ki += 1
                elif ti < len(tbs) - 1:
                    ti += 1
                elif di < len(tps) - 1:
                    di += 1
                elif mi > 0:
                    mi -= 1
                else:
                    bi -= 1
                if self._feasible(model, bs_levels[bi], ms[mi], tbs[ti],
                                  ks[ki], tps[di]):
                    break
            b, m_c, tb, sk, tp = bs_levels[bi], ms[mi], tbs[ti], ks[ki], \
                tps[di]
        self.pool.set_slot_cap(model, b)
        # before scale_to: a degree change drains the mismatched
        # instances and the scale-up respawns at the new degree
        self.pool.set_tp_degree(model, tp)
        self.pool.scale_to(model, m_c)
        self.pool.set_token_budget(model, tb or None)
        self.pool.set_spec_k(model, sk)
        return cfg.quint_to_action(b, m_c, tb, sk, tp)

    # ---- decision epoch --------------------------------------------------
    def control(self) -> Dict[str, tuple]:
        """One decision per model: close the previous (s, a, r, s')
        transition, pick a new (b, m_c), and apply it to the pool. Call
        once per Eq.-1 slot."""
        applied = {}
        for model, agent in self.agents.items():
            s = self._state(model)
            if self.learn and model in self._last:
                s0, a0 = self._last[model]
                agent.observe(s0, a0, self._reward(model), s, False)
                agent.update()
            a = self._apply(model, agent.act(s))
            self._last[model] = (s, a)
            applied[model] = self.cfg.action_to_pair(a)
        return applied

    def tick(self, pool=None) -> Dict[str, tuple]:
        """Push-mode decision epoch: harvest the results completed since
        the last call from the pool's history, then run ``control()``."""
        if pool is not None and pool is not self.pool:
            raise ValueError("tick() got a different pool than the one "
                             "this scheduler controls")
        for model in self.pool.configs:
            hist = self.pool.results(model)
            seen = self._tick_seen.get(model, 0)
            if seen > len(hist):  # pool.reset_metrics() cleared history
                seen = 0
            self.record(hist[seen:])
            self._tick_seen[model] = len(hist)
        return self.control()


def collect_interference_dataset(cfg: ServingConfig, n: int = 2000,
                                 seed: int = 0):
    """Fig. 13 protocol: random (b, m_c) probes; features + actual latency."""
    env = EdgeServingEnv(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    X, y = [], []
    pending: Dict[tuple, np.ndarray] = {}
    s = env.reset()
    done = False
    seen = 0
    while len(X) < n:
        if done:
            env.seed += 1
            s = env.reset()
            pending.clear()
            seen = 0
        a = int(rng.integers(env.n_actions))
        s, r, done, info = env.step(a)
        for rnd in env.history[seen:]:
            # overflow rounds take the failure-penalty path, not the
            # interference latency model — they are not prediction targets
            if rnd.features is not None and not rnd.overflow:
                X.append(rnd.features)
                y.append(max(rnd.finish_ms - rnd.start_ms, 1e-3) / 1000.0)
        seen = len(env.history)
    return np.stack(X[:n]), np.asarray(y[:n], np.float64)
