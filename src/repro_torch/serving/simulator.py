"""Discrete-event simulator of a multi-tenant edge serving platform.

The port of ``repro.serving.simulator``: numpy on the host, as in the
reference, so under the same config, seed and action sequence it steps
exactly as the reference does. The Xavier-NX/Nano/TX2 hardware is simulated
by the calibrated latency model (docs/ARCHITECTURE.md §2). Semantics follow
the paper:

* requests arrive Poisson (§V-A), one SLO-priority queue per model (§IV-C);
* a scheduling decision for a model picks (b, m_c); the dynamic batcher
  then FORMS the round: it waits until b requests are queued or the
  Eq.-1 scheduling slot t_i = Σ SLO / m_c elapses (adaptive batching's
  time-window — this queue wait t_w is exactly why larger batches trade
  latency for throughput, Fig. 1);
* m_c instances execute concurrently (§IV-D) under the interference model;
* the next decision for a model happens when its round completes;
* reward = utility U (Eq. 3/6) of the round; memory overflow fails it.

Under ``ServingConfig.exec_mode == "continuous"`` the round is replaced by
an iteration-level *session* (docs/ARCHITECTURE.md §5): the action becomes
(max slots per instance, concurrency), the session advances one decode
iteration at a time ("iter" events in the heap loop), finished requests
leave and queued requests join at iteration boundaries, and utility/SLO
metrics (Eq. 3/6) are computed per request rather than per round.

Because rounds of different models overlap in time, the env is a per-model
semi-MDP (docs/ARCHITECTURE.md §3): ``step(action)`` commits the focus
model's round and advances the event loop to the NEXT decision point (any
model). Completed transitions (s, a, r, s') are emitted in
``info["transitions"]`` when their model reaches its next decision, so the
RL agents see properly-ordered per-model experience.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.core.interference import interference_features
from repro_torch.core.utility import utility
from repro_torch.serving import latency_model as lm
from repro_torch.serving.features import featurize, state_dim
from repro_torch.serving.platforms import PLATFORMS, HardwareSpec
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.workload import PoissonWorkload

IDLE, PENDING, ACTIVE = 0, 1, 2


@dataclasses.dataclass
class CompletedRound:
    """One completed execution unit: a (b, m_c) round (paper §IV-D), or —
    under exec_mode="continuous" — a whole iteration-level session
    (docs/ARCHITECTURE.md §5), in which case ``n_iters`` > 1 and the
    per-request lists carry the join/leave accounting."""
    model: str
    b: int
    m_c: int
    n_requests: int
    decision_ms: float
    start_ms: float
    finish_ms: float
    latencies_ms: List[float]
    violations: int
    overflow: bool
    utility: float
    mem_used_gb: float
    features: object = None  # interference-predictor features at start
    exec_mode: str = "round"
    n_iters: int = 1         # decode iterations (1 = single-shot round)
    queue_waits_ms: Optional[List[float]] = None  # per request, >= 0
    request_utilities: Optional[List[float]] = None  # per-request Eq. 3
    n_preempted: int = 0     # preemptions during this session
    token_budget: int = 0    # per-iteration token cap (0 = uncapped)
    spec_k: int = 0          # speculative proposal depth (0 = off)

    @property
    def throughput_rps(self) -> float:
        dur = max(self.finish_ms - self.decision_ms, 1e-3)
        return 1000.0 * self.n_requests / dur


@dataclasses.dataclass
class _Pending:
    model: str
    b: int
    m_c: int
    target: int
    decision_ms: float
    deadline_ms: float
    state: np.ndarray
    action: int
    token_budget: int = 0    # per-iteration token cap (0 = uncapped)
    spec_k: int = 0          # speculative proposal depth (0 = off)


@dataclasses.dataclass
class _Session:
    """In-flight continuous-batching session (docs/ARCHITECTURE.md §5).

    ``b * m_c`` KV slots are allocated for the whole session; ``active``
    requests each consume one slot until their ``remaining`` decode
    iterations run out, at which point they leave and a queued request
    may join at the next iteration boundary. Admission closes at
    ``admit_until_ms`` (the Eq.-1 scheduling slot) so the session — and
    with it the semi-MDP decision epoch — always terminates."""
    model: str
    b: int
    m_c: int
    decision_ms: float
    start_ms: float
    admit_until_ms: float
    mem_gb: float
    state: np.ndarray
    action: int
    active: List[Request] = dataclasses.field(default_factory=list)
    done: List[Request] = dataclasses.field(default_factory=list)
    n_iters: int = 0
    features: object = None
    token_budget: int = 0    # per-iteration token cap (0 = uncapped)
    n_preempted: int = 0
    spec_k: int = 0          # speculative proposal depth (0 = off)

    @property
    def capacity(self) -> int:
        return self.b * self.m_c

    def plan_tokens(self) -> Tuple[int, List[int]]:
        """Work of the NEXT iteration under the token budget: decoding
        requests take one token each; the leftover budget is handed to
        prefilling requests in admission order (chunked prefill,
        docs/ARCHITECTURE.md §5). Deterministic between scheduling the
        ``iter`` event and handling it — joins/leaves only happen at
        iteration boundaries — so the event's latency prices exactly the
        work the handler then applies. Returns (total tokens,
        per-request prefill allocation parallel to ``active``).

        With speculation on (``spec_k`` > 0) every decoding request
        costs ``1 + spec_k`` tokens — the verify forward processes the
        pending token plus k drafts — which is exactly how the real
        engine's verify step bills the token budget. The *progress* per
        iteration (acceptance) is drawn in ``_handle_iter``; the COST is
        always the full proposal."""
        n_dec = sum(1 for r in self.active if r.prefill_remaining <= 0)
        n_dec *= 1 + max(0, self.spec_k)
        cap = self.token_budget if self.token_budget > 0 else (1 << 62)
        left = max(0, cap - n_dec)
        alloc: List[int] = []
        for r in self.active:
            take = min(left, r.prefill_remaining) \
                if r.prefill_remaining > 0 else 0
            alloc.append(take)
            left -= take
        return n_dec + sum(alloc), alloc


class EdgeServingEnv:
    """Per-model semi-MDP serving environment (paper §IV; event-loop and
    decision semantics in docs/ARCHITECTURE.md §3, continuous mode §5).

    ``step(action)`` commits the focus model's (b, m_c) round — or
    continuous session — and advances the discrete-event loop to the
    next decision point of any model; ``info["transitions"]`` carries
    the completed per-model (s, a, r, s') tuples."""

    def __init__(self, cfg: ServingConfig = ServingConfig(),
                 models: Optional[Sequence[str]] = None,
                 episode_ms: float = 60_000.0, seed: int = 0):
        self.cfg = cfg
        self.hw: HardwareSpec = PLATFORMS[cfg.platform]
        self.models = list(models or EDGE_MODELS.keys())
        self.episode_ms = episode_ms
        self.seed = seed
        self.state_dim = state_dim(self.models)
        self.n_actions = cfg.n_actions
        self.history: List[CompletedRound] = []
        self.reset()

    # ------------------------------------------------------------ reset
    def reset(self) -> np.ndarray:
        self.now = 0.0
        self.workload = PoissonWorkload(
            self.cfg.arrival_rps, self.models, seed=self.seed,
            decode_steps_mean=self.cfg.decode_steps_mean,
            prefill_tokens_mean=self.cfg.prefill_tokens_mean,
            shared_prefix_tokens=self.cfg.shared_prefix_tokens,
            prefix_population=self.cfg.prefix_population)
        #: prefix cache twin (docs/ARCHITECTURE.md §5): per-model set of
        #: shared-prefix ids some admitted request already prefilled —
        #: later same-prefix admissions skip those tokens
        self._seen_prefixes: Dict[str, set] = {m: set()
                                               for m in self.models}
        self.prefix_hit_tokens = 0
        #: speculation twin (docs/ARCHITECTURE.md §speculation): decode
        #: progress per iteration is 1 + the run of consecutive draft
        #: acceptances, each a Bernoulli(cfg.spec_accept_rate) draw from
        #: a dedicated stream (spec-off runs consume no draws, so their
        #: traces are bit-identical to pre-speculation builds)
        self._spec_rng = np.random.default_rng(self.seed + 1)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.queues: Dict[str, RequestQueue] = {
            m: RequestQueue(m, self.cfg.max_queue) for m in self.models}
        self._events: List[tuple] = []
        self._evseq = 0
        self.status: Dict[str, int] = {m: IDLE for m in self.models}
        self.pending: Dict[str, _Pending] = {}
        self.active: Dict[str, Tuple[int, float]] = {}  # model -> (inst, mem)
        self._last_sa: Dict[str, Tuple[np.ndarray, int]] = {}
        self._ready_reward: Dict[str, float] = {}
        self._out_transitions: List[tuple] = []
        self.history = []
        self.total_requests = 0
        self._focus = self.models[0]  # placeholder until first decision
        r = self.workload.next_request()
        self._push_event(r.arrival_ms, "arrival", r)
        self._advance_to_decision()
        return self._observe(self._focus)

    def _push_event(self, t: float, kind: str, payload) -> None:
        self._evseq += 1
        heapq.heappush(self._events, (t, self._evseq, kind, payload))

    # ------------------------------------------------------------ event loop
    def _handle_arrival(self, r: Request) -> None:
        self.queues[r.model].push(r)
        self.total_requests += 1
        nxt = self.workload.next_request()
        self._push_event(nxt.arrival_ms, "arrival", nxt)
        p = self.pending.get(r.model)
        if p and len(self.queues[r.model]) >= p.target:
            self._start_round(p)

    def _handle_deadline(self, model: str) -> None:
        p = self.pending.get(model)
        if not p or self.now < p.deadline_ms - 1e-9:
            return  # stale deadline (round already started)
        if len(self.queues[model]) == 0:
            # nothing arrived inside the slot: no-op round, zero reward
            self.pending.pop(model)
            self.status[model] = IDLE
            self._ready_reward[model] = 0.0
            return
        self._start_round(p)

    def _start_round(self, p: _Pending) -> None:
        if self.cfg.exec_mode == "continuous":
            return self._start_session(p)
        model = p.model
        self.pending.pop(model, None)
        prof = EDGE_MODELS[model]
        q = self.queues[model]
        # formation waits for ONE batch (b); at dispatch all m_c instances
        # pull whatever is queued, up to b each (Triton instance semantics)
        slo_sum_ms = q.slo_sum_ms(p.b * p.m_c) * self.cfg.slo_scale
        reqs = q.pop_batch(p.b * p.m_c)
        n = len(reqs)
        b_eff = max(1, int(np.ceil(n / p.m_c)))
        other_inst, other_mem = self._other_load(exclude=model)
        est = lm.estimate_execution(self.hw, prof, b_eff, p.m_c,
                                    other_inst, other_mem)
        # run-to-completion: the whole batch decodes in lock-step until the
        # LONGEST sequence finishes (single-shot requests: n_iters = 1, the
        # paper's CNN/BERT regime; exec_mode="continuous" removes this wait)
        n_iters = max([r.decode_steps for r in reqs], default=1)
        t_exec = est.total_ms * n_iters
        if est.overflow:
            t_exec = 10.0 * max(slo_sum_ms / max(p.m_c, 1),
                                self.hw.overhead_ms)
        start = self.now
        finish = start + t_exec
        self.status[model] = ACTIVE
        self.active[model] = (p.m_c, est.mem_used_gb - other_mem)

        t_t = lm.transmission_ms(self.hw, prof)
        t_s = lm.serialization_ms(b_eff)
        lats, waits, violations = [], [], 0
        for r in reqs:
            r.start_ms = start
            r.finish_ms = finish + t_t + t_s
            lat = r.latency_ms()
            lats.append(lat)
            waits.append(r.queue_wait_ms())
            if est.overflow or lat > r.slo_ms * self.cfg.slo_scale:
                violations += 1

        # utility (Eq. 3) with T_{t_i} = requests per scheduling slot
        # (Eq. 1): U = log( (n/t_i) / (L/t_i) ) — the slot cancels, giving
        # a clean requests-per-second-of-latency trade-off with an interior
        # optimum in (b, m_c), as in Fig. 1.
        slot_s = max(slo_sum_ms, 1.0) / 1000.0 / max(p.m_c, 1)
        thr = n / slot_s
        mean_lat_s = (float(np.mean(lats)) if lats else t_exec) / 1000.0
        u = utility(max(thr, 1e-3), mean_lat_s,
                    max(slo_sum_ms, 1.0) / 1000.0, p.m_c)
        # Eq. 4 constraints as penalties: SLO misses and memory overflow
        u -= 3.5 * (violations / max(n, 1))
        if est.overflow:
            u -= 5.0
        feats = interference_features(
            self.hw.mem_gb - other_mem, 0.3 + 0.05 * other_inst,
            self._accel_util(), p.m_c, b_eff, prof.gflops,
            est.mem_used_gb - other_mem)
        rnd = CompletedRound(model, p.b, p.m_c, n, p.decision_ms, start,
                             finish, lats, violations, est.overflow, u,
                             est.mem_used_gb, feats, exec_mode="round",
                             n_iters=n_iters, queue_waits_ms=waits)
        self._push_event(finish, "complete", rnd)

    def _handle_complete(self, rnd: CompletedRound) -> None:
        self.active.pop(rnd.model, None)
        self.status[rnd.model] = IDLE
        self.history.append(rnd)
        self._ready_reward[rnd.model] = rnd.utility

    # ------------------------------------------- continuous sessions (§5)
    def _start_session(self, p: _Pending) -> None:
        """Continuous-mode dispatch (docs/ARCHITECTURE.md §5): allocate
        b*m_c KV slots for an iteration-level session instead of forming a
        run-to-completion round."""
        model = p.model
        self.pending.pop(model, None)
        prof = EDGE_MODELS[model]
        other_inst, other_mem = self._other_load(exclude=model)
        own_mem = p.m_c * lm.instance_memory_gb(prof, p.b)
        mem = own_mem + other_mem
        self.status[model] = ACTIVE
        self.active[model] = (p.m_c, own_mem)
        if mem > self.hw.mem_gb:
            # Eq.-4 memory violation: the slot allocation itself does not
            # fit — fail the formed batch outright, as round mode does
            reqs = self.queues[model].pop_batch(p.b * p.m_c)
            t_fail = 10.0 * max(prof.slo_ms * self.cfg.slo_scale,
                                self.hw.overhead_ms)
            finish = self.now + t_fail
            lats, waits = [], []
            for r in reqs:
                r.start_ms = self.now
                r.finish_ms = finish
                lats.append(r.latency_ms())
                waits.append(r.queue_wait_ms())
            rnd = CompletedRound(model, p.b, p.m_c, len(reqs),
                                 p.decision_ms, self.now, finish, lats,
                                 len(reqs), True, -8.5, mem, None,
                                 exec_mode="continuous", n_iters=1,
                                 queue_waits_ms=waits)
            self._push_event(finish, "complete", rnd)
            return
        # admission window = the Eq.-1 scheduling slot for the allocation:
        # t_i = Σ_{j=1..b*m_c} SLO / m_c ≈ b * SLO. After it closes the
        # session drains, so the semi-MDP decision epoch always terminates.
        admit_window = p.b * prof.slo_ms * self.cfg.slo_scale
        sess = _Session(model, p.b, p.m_c, p.decision_ms, self.now,
                        self.now + admit_window, mem, p.state, p.action,
                        token_budget=p.token_budget, spec_k=p.spec_k)
        sess.features = interference_features(
            self.hw.mem_gb - other_mem, 0.3 + 0.05 * other_inst,
            self._accel_util(), p.m_c, p.b, prof.gflops, own_mem)
        self._session_join(sess)
        self._push_event(self.now + self._iter_ms(sess), "iter", sess)

    def _session_join(self, sess: _Session) -> int:
        """Admit queued requests into free slots (iteration boundary).
        A joining request first owes its prompt's prefill (chunked under
        the session token budget); decode starts once it is paid."""
        if self.now > sess.admit_until_ms:
            return 0
        q = self.queues[sess.model]
        n = 0
        while len(sess.active) < sess.capacity and len(q):
            r = q.pop_batch(1)[0]
            r.start_ms = self.now
            if r.n_preempted == 0:
                # fresh admission; a resumed request keeps the decode
                # progress it already earned (remaining) and the
                # recompute bill set at preemption time
                # (prefill_remaining = prompt + emitted context)
                r.remaining = max(1, r.decode_steps)
                r.prefill_remaining = r.prefill_tokens
                if self.cfg.prefix_cache and r.prefix_id >= 0:
                    # prefix-cache twin: a shared prefix some earlier
                    # request of this model already prefilled is skipped
                    # (the engine's block-sharing hit, analytically)
                    seen = self._seen_prefixes[sess.model]
                    if r.prefix_id in seen:
                        r.prefill_remaining = max(
                            0, r.prefill_remaining - r.prefix_tokens)
                        self.prefix_hit_tokens += r.prefix_tokens
                    else:
                        seen.add(r.prefix_id)
            sess.active.append(r)
            n += 1
        return n

    def _iter_ms(self, sess: _Session) -> float:
        """Latency of ONE iteration pricing the tokens it processes:
        resident decodes plus budget-bounded prefill chunks (each prompt
        token costs like one decode row, so the batch dimension is the
        iteration's total token work)."""
        prof = EDGE_MODELS[sess.model]
        tokens, _ = sess.plan_tokens()
        b_eff = max(1, int(np.ceil(tokens / sess.m_c)))
        other_inst, other_mem = self._other_load(exclude=sess.model)
        est = lm.estimate_execution(self.hw, prof, b_eff, sess.m_c,
                                    other_inst, other_mem)
        return est.total_ms

    def _maybe_preempt(self, sess: _Session) -> None:
        """SLO-aware preemption (docs/RUNTIME.md §8), simulator twin of
        the pool policy: when the session is full, the most urgent queued
        request's slack no longer covers its predicted service time, and
        a resident decoding request out-slacks it by the hysteresis
        margin, evict that largest-slack resident back to the queue with
        a recompute bill (prompt + emitted context re-prefilled on
        resume). At most one eviction per iteration; per-request cap."""
        if not self.cfg.preemption or len(sess.active) < sess.capacity:
            return
        slack_ms, urgent = self.queues[sess.model].peek_most_urgent(self.now)
        if urgent is None:
            return
        iter_ms = self._iter_ms(sess)
        need_ms = (urgent.decode_steps + urgent.prefill_tokens
                   / max(1, sess.token_budget or urgent.prefill_tokens or 1)
                   ) * iter_ms
        if slack_ms >= need_ms:
            return
        margin = self.cfg.preempt_margin_ms
        best = None
        for r in sess.active:
            if r.prefill_remaining > 0:   # never a mid-chunk prefill
                continue
            if r.n_preempted >= self.cfg.max_preemptions:
                continue
            if r.slo_ms <= urgent.slo_ms:
                # the queue pops shortest-SLO first: a victim whose SLO
                # class is not strictly laxer would re-admit ahead of the
                # urgent request at this very boundary (thrash)
                continue
            vslack = r.deadline_ms - self.now
            if vslack <= slack_ms + margin:
                continue
            if best is None or vslack > best[0]:
                best = (vslack, r)
        if best is None:
            return
        victim = best[1]
        sess.active.remove(victim)
        victim.n_preempted += 1
        emitted = victim.decode_steps - victim.remaining
        victim.prefill_remaining = victim.prefill_tokens + emitted
        sess.n_preempted += 1
        if not self.queues[sess.model].push(victim):
            # queue full: the evicted request is dropped (counted there)
            pass

    def _handle_iter(self, sess: _Session) -> None:
        """One iteration just finished: apply its planned prefill/decode
        work, then leaves, preemption check, joins, then either the next
        iteration or session completion."""
        _, alloc = sess.plan_tokens()
        sess.n_iters += 1
        prof = EDGE_MODELS[sess.model]
        t_t = lm.transmission_ms(self.hw, prof)
        still = []
        for r, take in zip(sess.active, alloc):
            if r.prefill_remaining > 0:
                r.prefill_remaining -= take
                still.append(r)
                continue
            # speculative advance: 1 committed token plus the run of
            # consecutively-accepted drafts (acceptance is prefix-based
            # in the real engine, so the first rejection ends the run)
            adv = 1
            for _ in range(max(0, sess.spec_k)):
                self.spec_proposed += 1
                if self._spec_rng.random() >= self.cfg.spec_accept_rate:
                    break
                self.spec_accepted += 1
                adv += 1
            r.remaining -= adv
            if r.remaining <= 0:
                r.finish_ms = self.now + t_t + lm.serialization_ms(1)
                sess.done.append(r)
            else:
                still.append(r)
        sess.active = still
        self._maybe_preempt(sess)
        self._session_join(sess)
        if sess.active:
            self._push_event(self.now + self._iter_ms(sess), "iter", sess)
        else:
            self._finish_session(sess)

    def _finish_session(self, sess: _Session) -> None:
        """Per-request utility/SLO accounting (Eq. 3/6 per request, then
        averaged) — the continuous-mode replacement for round utility."""
        n = len(sess.done)
        dur_s = max(self.now - sess.decision_ms, 1e-3) / 1000.0
        thr = n / dur_s
        lats, waits, utils = [], [], []
        violations = 0
        for r in sess.done:
            lat = r.latency_ms()
            lats.append(lat)
            waits.append(r.queue_wait_ms())
            if lat > r.slo_ms * self.cfg.slo_scale:
                violations += 1
            utils.append(utility(
                max(thr, 1e-3), lat / 1000.0,
                r.slo_ms * self.cfg.slo_scale / 1000.0, sess.m_c))
        u = float(np.mean(utils)) if utils else 0.0
        u -= 3.5 * (violations / max(n, 1))
        rnd = CompletedRound(sess.model, sess.b, sess.m_c, n,
                             sess.decision_ms, sess.start_ms, self.now,
                             lats, violations, False, u, sess.mem_gb,
                             sess.features, exec_mode="continuous",
                             n_iters=sess.n_iters, queue_waits_ms=waits,
                             request_utilities=utils,
                             n_preempted=sess.n_preempted,
                             token_budget=sess.token_budget,
                             spec_k=sess.spec_k)
        self._handle_complete(rnd)

    # ------------------------------------------------------------ decisions
    def _decision_ready(self) -> List[str]:
        return [m for m in self.models
                if self.status[m] == IDLE and len(self.queues[m]) > 0]

    def _advance_to_decision(self) -> bool:
        """Process events until a decision point exists. Returns done."""
        while True:
            ready = self._decision_ready()
            if ready:
                self._focus = max(
                    ready,
                    key=lambda m: self.queues[m].peek_oldest_age(self.now))
                return self.now >= self.episode_ms
            if not self._events:
                return True
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = max(self.now, t)
            if self.now >= self.episode_ms and kind == "arrival":
                return True
            if kind == "arrival":
                self._handle_arrival(payload)
            elif kind == "deadline":
                self._handle_deadline(payload)
            elif kind == "iter":
                self._handle_iter(payload)
            elif kind == "complete":
                self._handle_complete(payload)

    # ------------------------------------------------------------ resources
    def _other_load(self, exclude: str) -> Tuple[int, float]:
        inst = sum(i for m, (i, _) in self.active.items() if m != exclude)
        mem = sum(g for m, (_, g) in self.active.items() if m != exclude)
        return inst, mem

    def _accel_util(self) -> float:
        u = 0.0
        for m, (inst, _) in self.active.items():
            u += inst * lm.batching_efficiency(self.hw, 8)
        return min(1.0, u)

    def _observe(self, model: str) -> np.ndarray:
        q = self.queues[model]
        inst, mem = self._other_load(exclude="")
        return featurize(model, self.models, self.hw, len(q),
                         q.peek_oldest_age(self.now), mem, inst,
                         self._accel_util())

    def predict_features(self, model: str, b: int, m_c: int) -> np.ndarray:
        prof = EDGE_MODELS[model]
        inst, mem = self._other_load(exclude=model)
        return interference_features(
            self.hw.mem_gb - mem, 0.3 + 0.05 * inst, self._accel_util(),
            m_c, b, prof.gflops, m_c * lm.instance_memory_gb(prof, b))

    FORMATION_FRAC = 0.25  # batch-collection share of the Eq.-1 slot

    def slot_budget_ms(self, model: str, b: int, m_c: int) -> float:
        """Formation window: a quarter of the Eq.-1 slot t_i = Σ SLO / m_c
        (execution + transmission must fit in the remainder, else every
        formed batch would already be past its budget)."""
        slot = b * m_c * EDGE_MODELS[model].slo_ms * self.cfg.slo_scale \
            / max(m_c, 1)
        return self.FORMATION_FRAC * slot

    # ------------------------------------------------------------ step
    def step(self, action: int) -> Tuple[np.ndarray, float, bool, Dict]:
        model = self._focus
        state = self._observe(model)
        b, m_c, token_budget, spec_k = self.cfg.action_to_quad(action)
        target = b  # formation waits for one instance-batch
        budget = self.slot_budget_ms(model, b, m_c)
        p = _Pending(model, b, m_c, target, self.now, self.now + budget,
                     state, action, token_budget=token_budget,
                     spec_k=spec_k if self.cfg.exec_mode == "continuous"
                     else 0)
        self.status[model] = PENDING
        self.pending[model] = p
        self._last_sa[model] = (state, action)
        if len(self.queues[model]) >= target:
            self._start_round(p)
        else:
            self._push_event(p.deadline_ms, "deadline", model)

        done = self._advance_to_decision()
        obs = self._observe(self._focus) if not done else state

        # emit per-model transitions whose reward is ready and whose model
        # is at (or past) its next decision
        transitions = []
        for m, r in list(self._ready_reward.items()):
            if m in self._last_sa and (self.status[m] == IDLE or done):
                s0, a0 = self._last_sa.pop(m)
                s1 = self._observe(m)
                transitions.append((s0, a0, r, s1, done))
                self._ready_reward.pop(m)
        last_round = self.history[-1] if self.history else None
        info = {"transitions": transitions, "model": model, "b": b,
                "m_c": m_c, "round": last_round}
        reward = transitions[-1][2] if transitions else 0.0
        return obs, float(reward), done, info

    # ------------------------------------------------------------ summary
    def summarize(self) -> Dict[str, float]:
        rounds = self.history
        if not rounds:
            return {}
        n_req = sum(r.n_requests for r in rounds)
        viol = sum(r.violations for r in rounds)
        lats = [l for r in rounds for l in r.latencies_ms]
        waits = [w for r in rounds for w in (r.queue_waits_ms or [])]
        return {
            "rounds": float(len(rounds)),
            "requests": float(n_req),
            "mean_utility": float(np.mean([r.utility for r in rounds])),
            "throughput_rps": 1000.0 * n_req / max(self.now, 1.0),
            # goodput = SLO-met completions per second (Eq. 4 objective)
            "goodput_rps": 1000.0 * (n_req - viol) / max(self.now, 1.0),
            "mean_latency_ms": float(np.mean(lats)) if lats else 0.0,
            "p50_latency_ms": float(np.percentile(lats, 50)) if lats else 0.0,
            "p99_latency_ms": float(np.percentile(lats, 99)) if lats else 0.0,
            "mean_queue_wait_ms": float(np.mean(waits)) if waits else 0.0,
            "slo_violation_rate": viol / max(n_req, 1),
            "overflow_rate": float(np.mean([r.overflow for r in rounds])),
            "mean_batch": float(np.mean([r.n_requests for r in rounds])),
            "mean_mc": float(np.mean([r.m_c for r in rounds])),
            "mean_iters": float(np.mean([r.n_iters for r in rounds])),
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
        }
