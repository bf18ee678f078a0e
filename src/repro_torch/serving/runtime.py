"""Multi-model concurrent serving runtime, the REAL m_c axis: the port of
``repro.serving.runtime`` (docs/RUNTIME.md; state machine, admission
rules and Eq.-1 accounting are specified there).

``ModelInstancePool`` owns N live ``ContinuousBatchingEngine`` instances
across heterogeneous ``ModelConfig``s, so a ``(b, m_c)`` action really
creates and destroys concurrent engine instances:

* **router**: one earliest-deadline-first queue per model; at every
  iteration boundary waiting requests are admitted into the least-loaded
  RUNNING instance of their model;
* **lifecycle**: ``scale_to(model, m_c)`` spawns or drains instances
  (STARTING -> RUNNING -> DRAINING -> RETIRED); draining instances finish
  their resident sequences before they retire, so scale-down never
  truncates in-flight work;
* **interference path**: every ``step()`` measures the wall-clock
  iteration latency together with the number of busy instances that
  overlapped it; the samples calibrate the contention model
  (``latency_model.fit_contention``) and, via ``engine_features``, feed
  the §IV-F interference predictor.

Instances of one model share one params dict (``share_from``), so
``spawn`` only allocates a KV cache; each instance keeps its own cache,
block table and slots. Under ``kv_layout="paged"`` the pool shares ONE
``kv_block_budget`` across instances: ``spawn``/``scale_to`` are bounded
by free blocks, admission gates on each engine's allocator, and every
pure-decode iteration records occupancy samples
(``latency_model.fit_occupancy``) that the ``PoolScheduler``'s memory
guard prices (b, m_c) against.

With ``prefix_cache=True`` (paged) every instance whose model pages all
its layers shares full prompt blocks between same-prefix sequences, and
the router prefers the instance whose cache already holds a request's
prefix; a model with windowed or recurrent layers serves without the
cache.

With ``preemption=True`` the router evicts the largest-slack resident
(never a mid-chunk prefill) when the most urgent waiting request cannot be
admitted and its slack no longer covers its predicted service time. The
victim resumes through ``submit_resume``, by recomputing its context or,
with a host tier (``kv_host_blocks`` per paged instance), by swapping its
blocks back: ``preempt_mode`` forces either, or ("auto") prices both with
the calibrated token-cost and swap-cost fits per victim. A swap snapshot
resumes only on its source instance and falls back to recompute when
that instance drains or retires. ``cancel`` tears a request down at any
phase and frees its blocks (host blocks included) at once.

``spec_k`` caps speculative decoding: instances of a model whose every
layer can rewind are built for that depth, and ``set_spec_k`` (the
``PoolScheduler``'s fourth axis) moves the live depth within it; other
models serve with k = 0.

Every instance runs on the pool's ``device`` (default ``"cuda"``, which
raises without a GPU; ``device="cpu"`` runs the kernels' plain versions).

Tensor parallelism: ``tp_degree`` (per model, ``set_tp_degree``, the
``PoolScheduler``'s fifth axis) is the degree new instances of a model
spawn at; an instance at degree d spans a ``("model",)`` mesh of d
devices (d shards on the CPU, the first d GPUs on the card, or the first
d of ``tp_devices``, which may repeat one card), so with
``n_devices`` set, Σ tp over the live instances caps further spawns and
m_c and the degree partition the device set together. A paged instance at
degree d is charged ``ceil(grant / d)`` budget blocks, a budget block
being per device, and keeps the whole grant. A degree change drains the
instances at the old degree; the next ``scale_to`` respawns.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.core.interference import engine_features
from repro_torch.core.utility import utility
from repro_torch.device import resolve_device, to_device
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import latency_model as lm
from repro_torch.serving import request as lifecycle
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        ContinuousResult, PreemptedRequest,
                                        supports_prefix_cache,
                                        supports_speculation, to_recompute)
from repro_torch.serving.request import RequestLifecycle

# instance lifecycle states (docs/RUNTIME.md state machine)
STARTING = "starting"
RUNNING = "running"
DRAINING = "draining"
RETIRED = "retired"

_seq = itertools.count()

#: trailing window the contention/occupancy fits read (and the bound the
#: sample lists are trimmed to, so long-lived serving loops do not leak)
_SAMPLE_WINDOW = 512


@dataclasses.dataclass
class PoolRequest:
    """One request routed by the pool (paper §III-A-1, with an absolute
    deadline for the EDF router)."""
    request_id: int
    model: str
    prompt: np.ndarray
    slo_ms: float
    max_new_tokens: int
    submit_s: float            # pool clock
    admit_s: float = -1.0      # set by the router at admission
    #: preempted-sequence snapshot awaiting re-admission; the router
    #: resumes it through ``engine.submit_resume`` instead of a fresh
    #: submit
    resume: Optional[PreemptedRequest] = None
    n_preempted: int = 0
    #: pool-clock time the first token landed (-1 before any token); kept
    #: by the pool so it survives a resume on another instance
    first_token_s: float = -1.0
    #: push-mode state machine; always attached by ``submit``
    lifecycle: Optional[RequestLifecycle] = None

    @property
    def deadline_s(self) -> float:
        return self.submit_s + self.slo_ms / 1000.0


@dataclasses.dataclass
class PoolResult:
    """One finished (or rejected) request, with per-request Eq.-3
    utility computed at completion time."""
    request_id: int
    model: str
    instance_id: int           # -1 when rejected before admission
    tokens: np.ndarray
    submit_s: float
    admit_s: float
    finish_s: float
    slo_ms: float
    utility: float = 0.0
    rejected: bool = False
    #: torn down before finishing (client disconnect or explicit cancel);
    #: ``tokens`` holds the partial completion
    cancelled: bool = False
    #: pool-clock first-token time (-1 if no token landed)
    first_token_s: float = -1.0

    @property
    def latency_ms(self) -> float:
        return (self.finish_s - self.submit_s) * 1000.0

    @property
    def ttft_ms(self) -> float:
        """Submit -> first token (-1 if no token landed)."""
        return (self.first_token_s - self.submit_s) * 1000.0 \
            if self.first_token_s >= 0 else -1.0

    @property
    def tpot_ms(self) -> float:
        """Mean ms per token after the first (-1 below two tokens)."""
        if self.first_token_s < 0 or len(self.tokens) < 2:
            return -1.0
        return (self.finish_s - self.first_token_s) * 1000.0 \
            / (len(self.tokens) - 1)

    @property
    def violated(self) -> bool:
        # a cancelled request has no completion to be late: the client
        # walked away; report() counts cancellations separately
        if self.cancelled:
            return False
        return self.rejected or self.latency_ms > self.slo_ms


class ModelInstance:
    """One live engine instance plus its lifecycle state and the pool's
    per-instance bookkeeping (resident requests, Eq.-1 slot share)."""

    def __init__(self, instance_id: int, model: str,
                 engine: ContinuousBatchingEngine, kv_blocks: int = 0,
                 tp_degree: int = 1):
        self.instance_id = instance_id
        self.model = model
        self.engine = engine
        self.kv_blocks = kv_blocks  # share of the pool's block budget
        self.tp_degree = tp_degree  # devices this instance spans
        self.state = STARTING
        self.requests: Dict[int, PoolRequest] = {}  # engine rid -> request
        #: the engine's ``stats()`` when the instance retired (the engine
        #: itself is dropped then); None while it lives
        self.engine_stats: Optional[Dict[str, float]] = None

    @property
    def n_resident(self) -> int:
        """Sequences currently owned by this instance (decoding or
        waiting inside the engine for the next iteration boundary)."""
        return len(self.requests)

    @property
    def free_capacity(self) -> int:
        """Engine slots not held by a resident request."""
        return self.engine.n_slots - self.n_resident

    @property
    def slo_sum_ms(self) -> float:
        """Σ SLO over resident requests: this instance's contribution to
        the model's Eq.-1 scheduling slot."""
        return sum(r.slo_ms for r in self.requests.values())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ModelInstance({self.instance_id}, {self.model!r}, "
                f"{self.state}, resident={self.n_resident})")


class ModelInstancePool:
    """N concurrent engine instances behind per-model EDF queues. The
    unit of progress is ``step()``: route waiting requests, run one
    iteration on every busy instance, retire empty draining instances,
    and record the iteration's wall latency against the overlap level
    for interference calibration."""

    def __init__(self, configs: Dict[str, ModelConfig],
                 max_instances: int = 8, max_slots: int = 4,
                 max_seq: int = 128, seed: int = 0,
                 strict_admission: bool = False,
                 predictor=None, kv_layout: str = "dense",
                 block_size: int = 16,
                 kv_block_budget: Optional[int] = None,
                 blocks_per_instance: Optional[int] = None,
                 preemption: bool = False,
                 preempt_margin_ms: float = 50.0,
                 preempt_cooldown_steps: int = 8,
                 max_preemptions: int = 2,
                 kv_host_blocks: int = 0,
                 preempt_mode: str = "auto",
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_k: int = 0,
                 tp_degree: int = 1,
                 n_devices: Optional[int] = None,
                 tp_devices: Optional[Sequence] = None,
                 device="cuda"):
        if preempt_mode not in ("recompute", "swap", "auto"):
            raise ValueError(
                f"preempt_mode must be 'recompute', 'swap' or 'auto', "
                f"got {preempt_mode!r}")
        if kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {kv_host_blocks}")
        if kv_host_blocks > 0 and kv_layout != "paged":
            raise ValueError(
                "kv_host_blocks needs kv_layout='paged' (the host tier "
                "swaps block-granular KV)")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.device = resolve_device(device)
        self.configs = dict(configs)
        self.max_instances = max_instances
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.seed = seed
        self.strict_admission = strict_admission
        self.predictor = predictor
        #: paged KV serving: every instance's engine uses the block-pool
        #: layout and the pool shares ONE block budget across instances
        self.kv_layout = kv_layout
        self.block_size = block_size
        self.kv_block_budget = kv_block_budget
        self.kv_blocks_free = kv_block_budget
        #: prefix caching: paged engines share full immutable prompt
        #: blocks at refcount+1 and the router gains prefix affinity; a
        #: model whose stack cannot page every decode state serves
        #: without it (per-model capability, one flag)
        self.prefix_cache = prefix_cache and kv_layout == "paged"
        #: speculative decoding: the depth instances are built for, and
        #: the live depth per model (``set_spec_k``) within it; models
        #: whose cache cannot rewind serve with k = 0
        self.spec_cap = max(0, spec_k)
        self.spec_ks: Dict[str, int] = {m: self.spec_cap for m in configs}
        #: tensor parallelism: the degree each model's instances spawn at
        #: (``set_tp_degree``), the shared device set's size (None:
        #: unbudgeted), and one mesh per degree, built on first use over
        #: the pool's device, so same-degree instances span a value-equal
        #: mesh and share weights
        self.tp_degrees: Dict[str, int] = {
            m: max(1, tp_degree) for m in configs}
        self.n_devices = n_devices
        self.tp_devices = None if tp_devices is None else list(tp_devices)
        self._meshes: Dict[int, object] = {}
        #: target grant for a paged instance; default = dense-equivalent
        #: worst case
        self.blocks_per_instance = blocks_per_instance
        #: SLO-aware preemption: when the most urgent waiting request
        #: cannot be admitted anywhere and its slack no longer covers its
        #: predicted service time, evict the largest-slack resident (never
        #: a mid-chunk prefill), with margin, cooldown and a per-request
        #: cap against thrash. ``preempt_mode``: "recompute", "swap" (into
        #: the instance's host tier of ``kv_host_blocks`` blocks, where
        #: the victim can) or "auto" (the cheaper of the two, priced)
        self.preemption = preemption
        self.preempt_margin_ms = preempt_margin_ms
        self.preempt_cooldown_steps = preempt_cooldown_steps
        self.max_preemptions = max_preemptions
        self.preempt_mode = preempt_mode
        self.kv_host_blocks = kv_host_blocks
        self.n_preempted = 0
        self.n_swap_preempted = 0
        self.preempts_by_model: Dict[str, int] = {m: 0 for m in configs}
        self._last_preempt_step: Dict[str, int] = {}
        #: per-model per-iteration token budget applied to every live
        #: engine (None = uncapped); the scheduler's third knob
        self.token_budgets: Dict[str, Optional[int]] = {
            m: token_budget for m in configs}
        #: (tokens processed, iteration wall ms) over busy iterations
        #: that loaded no kernel: calibrates latency_model.fit_token_cost
        self.token_samples: List[Tuple[int, float]] = []
        #: the same samples keyed by TP degree, recorded only on
        #: iterations whose busy instances all share one degree (the
        #: per-degree fits the guard prices layouts with)
        self.tp_token_samples: Dict[int, List[Tuple[int, float]]] = {}
        #: (total resident sequences, Σ kv_used_tokens) per pure-decode
        #: iteration: calibrates latency_model.fit_occupancy
        self.occupancy_samples: List[Tuple[int, int]] = []
        self.instances: Dict[str, List[ModelInstance]] = {
            m: [] for m in self.configs}
        self.slot_caps: Dict[str, int] = {m: max_slots for m in self.configs}
        self.queues: Dict[str, List[tuple]] = {m: [] for m in self.configs}
        #: weight donors keyed (model, tp degree): instances share
        #: weights only at the same degree (their shards live on that
        #: degree's mesh)
        self._templates: Dict[Tuple[str, int],
                              ContinuousBatchingEngine] = {}
        #: per-model weights (the port's layout on ``device``) that every
        #: template is built with; absent = drawn from ``seed``
        self._params: Dict[str, Dict] = {}
        self.admission_log: List[Tuple[int, int]] = []  # (request, instance)
        self.retired: List[ModelInstance] = []
        self.n_rejected = 0
        self.n_cancelled = 0
        self.n_steps = 0
        #: per-request event listeners: request_id -> callable taking one
        #: dict per event ("prefill", "decode", "token", "preempted",
        #: "finished", "cancelled", "rejected"), fired synchronously inside
        #: pool calls; a listener that raises is dropped
        self._listeners: Dict[int, Callable] = {}
        self.n_listener_errors = 0
        #: client-observed serving metrics (pool clock, submit -> first
        #: token / finish), trimmed to the trailing window
        self.ttft_samples: List[float] = []
        self.tpot_samples: List[float] = []
        #: (busy instances, iteration wall ms) calibration samples
        self.contention_samples: List[Tuple[int, float]] = []
        self._results: Dict[str, List[PoolResult]] = {
            m: [] for m in self.configs}
        self._next_rid = 0
        self._next_iid = 0
        self._t0 = time.perf_counter()

    def load_params(self, model: str, params: Dict) -> None:
        """Serve ``model`` with ``params`` (the port's layout): every
        instance spawned from now on shares them, and live instances
        switch to them in place."""
        params = to_device(params, self.device)
        self._params[model] = params
        for (m, _), tmpl in self._templates.items():
            if m == model:
                tmpl.load_params(params)

    def load_jax_params(self, model: str, params_np: Dict) -> None:
        """:meth:`load_params` with the reference's weights (its param
        pytree with numpy leaves; see ``repro_torch.models.bridge``)."""
        self.load_params(model, params_from_jax(params_np,
                                                self.configs[model]))

    # ---- clock -----------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    # ---- push-mode events ------------------------------------------------
    def add_listener(self, request_id: int, fn: Callable) -> None:
        """Register ``fn(event_dict)`` for every lifecycle event of
        ``request_id``; removed on the terminal event (or when it
        raises)."""
        self._listeners[request_id] = fn

    def remove_listener(self, request_id: int) -> None:
        self._listeners.pop(request_id, None)

    def _emit(self, req: PoolRequest, event: str, **payload) -> None:
        fn = self._listeners.get(req.request_id)
        if fn is None:
            return
        ev = {"event": event, "request_id": req.request_id,
              "t_s": self.now()}
        ev.update(payload)
        try:
            fn(ev)
        except Exception:  # noqa: BLE001 (a dead client, not our bug)
            self.n_listener_errors += 1
            self._listeners.pop(req.request_id, None)

    def _on_engine_token(self, inst: ModelInstance, erid: int, tok: int,
                         idx: int) -> None:
        """The engine emitted token ``idx`` of the sequence it knows as
        ``erid``: stamp the pool-clock first-token time, push the event.
        ``idx`` is the global completion index, stable across
        preemption."""
        req = inst.requests.get(erid)
        if req is None:  # an engine-local sequence
            return
        now = self.now()
        if req.first_token_s < 0:
            req.first_token_s = now
        if req.lifecycle is not None:
            req.lifecycle.token(int(tok), int(idx), now)
        self._emit(req, "token", token=int(tok), index=int(idx))

    def _on_engine_state(self, inst: ModelInstance, erid: int,
                         state: str) -> None:
        """The engine moved the sequence between phases ("prefill" at slot
        assignment, "decode" at prefill completion)."""
        req = inst.requests.get(erid)
        if req is None:
            return
        if req.lifecycle is not None and not req.lifecycle.terminal:
            req.lifecycle.to(state, self.now())
        self._emit(req, state, instance_id=inst.instance_id)

    # ---- lifecycle -------------------------------------------------------
    def live(self, model: Optional[str] = None) -> List[ModelInstance]:
        """RUNNING + DRAINING instances (they still hold resources)."""
        models = [model] if model else list(self.instances)
        return [i for m in models for i in self.instances[m]
                if i.state in (RUNNING, DRAINING)]

    def running(self, model: str) -> List[ModelInstance]:
        return [i for i in self.instances[model] if i.state == RUNNING]

    def m_c(self, model: str) -> int:
        return len(self.running(model))

    def total_live(self) -> int:
        return len(self.live())

    def busy_count(self) -> int:
        """Live instances with resident work: the overlap level the
        contention samples are recorded against."""
        return sum(1 for i in self.live() if i.n_resident > 0)

    # ---- tensor parallelism ----------------------------------------------
    def devices_in_use(self) -> int:
        """Devices the live instances span: Σ tp_degree. With
        ``n_devices`` set this bounds further spawns."""
        return sum(i.tp_degree for i in self.live())

    def _tp_mesh(self, tp: int):
        """The mesh of degree ``tp`` (None at 1): the first ``tp`` of
        ``tp_devices``, else ``tp`` shards on the pool's CPU, or the first
        ``tp`` GPUs (``make_tp_mesh`` raises when fewer are given or
        visible). Cached per degree."""
        if tp <= 1:
            return None
        mesh = self._meshes.get(tp)
        if mesh is None:
            from repro_torch.launch.mesh import make_tp_mesh
            if self.tp_devices is not None:
                devices = self.tp_devices[:tp]
            else:
                devices = [self.device] * tp \
                    if self.device.type == "cpu" else None
            mesh = make_tp_mesh(tp, devices)
            self._meshes[tp] = mesh
        return mesh

    def set_tp_degree(self, model: str, tp: int) -> None:
        """The fifth knob: the TP degree of future spawns of ``model``. A
        live engine cannot re-shard, so RUNNING instances at another
        degree start DRAINING and the next ``scale_to`` respawns."""
        tp = max(1, tp)
        if self.tp_degrees.get(model) == tp:
            return
        self.tp_degrees[model] = tp
        for inst in self.instances[model]:
            if inst.state == RUNNING and inst.tp_degree != tp:
                inst.state = DRAINING

    def _dense_equiv_blocks(self) -> int:
        """The whole (max_slots, max_seq) slab expressed in blocks: what a
        dense instance commits by construction."""
        return self.max_slots * (-(-self.max_seq // self.block_size))

    def _min_viable_blocks(self) -> int:
        """Smallest grant a spawned paged instance can serve with: one
        slot's worst case, or a smaller explicit ``blocks_per_instance``."""
        one_slot = -(-self.max_seq // self.block_size)
        if self.blocks_per_instance:
            return min(one_slot, self.blocks_per_instance)
        return one_slot

    def _spawn_grant(self) -> int:
        """Blocks the next spawn would charge against the budget."""
        if self.kv_layout != "paged":
            return self._dense_equiv_blocks()
        return self.blocks_per_instance or self._dense_equiv_blocks()

    def can_spawn(self, model: Optional[str] = None) -> bool:
        """The instance budget, the device budget and the block budget
        allow one more spawn: a dense instance must fit its whole slab, a
        paged one can start on a partial grant (at least one slot's worth,
        charged per device). ``model`` prices that model's TP degree
        (degree 1 when omitted)."""
        if self.total_live() >= self.max_instances:
            return False
        tp = self.tp_degrees.get(model, 1) if model else 1
        if self.n_devices is not None and \
                self.devices_in_use() + tp > self.n_devices:
            return False
        if self.kv_blocks_free is None:
            return True
        if self.kv_layout == "paged":
            return self.kv_blocks_free >= \
                -(-self._min_viable_blocks() // tp)
        return self.kv_blocks_free >= self._dense_equiv_blocks()

    def spawn(self, model: str) -> ModelInstance:
        """STARTING -> RUNNING. Raises when the instance budget, the
        device set or the shared KV block budget is exhausted
        (``scale_to`` clamps)."""
        if self.total_live() >= self.max_instances:
            raise RuntimeError(
                f"pool at max_instances={self.max_instances}")
        tp = self.tp_degrees.get(model, 1)
        if self.n_devices is not None and \
                self.devices_in_use() + tp > self.n_devices:
            raise RuntimeError(
                f"device budget exhausted: {model!r} at tp_degree={tp} "
                f"needs {tp} of {self.n_devices} devices, "
                f"{self.n_devices - self.devices_in_use()} free")
        grant = charge = self._spawn_grant()
        if self.kv_blocks_free is not None:
            if self.kv_layout == "paged":
                # a head-split block spreads over the instance's tp
                # devices, so one (per-device) budget block buys tp pool
                # blocks: the charge is ceil(grant / tp) and the engine
                # keeps the whole grant
                charge = min(-(-grant // tp), self.kv_blocks_free)
                grant = charge * tp
                if grant < self._min_viable_blocks():
                    raise RuntimeError(
                        f"KV block budget exhausted "
                        f"({self.kv_blocks_free} free of "
                        f"{self.kv_block_budget})")
            elif self.kv_blocks_free < charge:
                raise RuntimeError(
                    f"KV block budget exhausted: dense slab needs "
                    f"{charge} blocks, {self.kv_blocks_free} free")
            self.kv_blocks_free -= charge
        elif self.kv_layout != "paged":
            grant = charge = 0  # unlimited dense pool: nothing to account
        kw = {}
        if self.kv_layout == "paged":
            kw = {"block_size": self.block_size, "kv_blocks": grant,
                  "prefix_cache": self.prefix_cache
                  and supports_prefix_cache(self.configs[model]),
                  # the host tier is single-device: a sharded instance
                  # resumes by recompute (its engine refuses the tier)
                  "kv_host_blocks": self.kv_host_blocks if tp == 1 else 0}
        if self.spec_cap > 0 and supports_speculation(self.configs[model]):
            kw["spec_k"] = self.spec_cap
        tmpl = self._templates.get((model, tp))
        eng = ContinuousBatchingEngine(
            self.configs[model], max_slots=self.max_slots,
            max_seq=self.max_seq, seed=self.seed, kv_layout=self.kv_layout,
            token_budget=self.token_budgets.get(model), device=self.device,
            params=self._params.get(model) if tmpl is None else None,
            share_from=tmpl, mesh=self._tp_mesh(tp), **kw)
        # spawn at the depth the scheduler set last (within the built cap)
        eng.spec_k = min(self.spec_ks.get(model, 0), eng.spec_max)
        if tmpl is None:
            self._templates[(model, tp)] = eng
        inst = ModelInstance(self._next_iid, model, eng, kv_blocks=charge,
                             tp_degree=tp)
        # the engine reports per-token emissions and phase changes; the
        # pool maps engine request ids to pool requests
        eng.on_token = (lambda erid, tok, idx, _inst=inst:
                        self._on_engine_token(_inst, erid, tok, idx))
        eng.on_state = (lambda erid, state, _inst=inst:
                        self._on_engine_state(_inst, erid, state))
        self._next_iid += 1
        self.instances[model].append(inst)
        inst.state = RUNNING  # engine construction == warm start
        return inst

    def drain(self, model: str, instance_id: Optional[int] = None) -> None:
        """RUNNING -> DRAINING: no new admissions; resident sequences run
        to completion, then the sweep retires the instance."""
        for inst in self.instances[model]:
            if inst.state == RUNNING and (instance_id is None
                                          or inst.instance_id == instance_id):
                inst.state = DRAINING
                if instance_id is not None:
                    return

    def scale_to(self, model: str, m_c: int) -> int:
        """Set the RUNNING instance count for ``model`` (idempotent).
        Scaling up revives DRAINING instances first, then spawns, clamped
        to the pool-wide budgets; scaling down drains the least-loaded
        instances. Returns the RUNNING count reached."""
        m_c = max(0, m_c)
        run = self.running(model)
        if len(run) > m_c:
            for inst in sorted(run, key=lambda i: i.n_resident)[
                    : len(run) - m_c]:
                inst.state = DRAINING
            return m_c
        # revive only instances at the current degree: reviving another
        # would undo a set_tp_degree decision
        draining = [i for i in self.instances[model]
                    if i.state == DRAINING
                    and i.tp_degree == self.tp_degrees.get(model, 1)]
        while len(self.running(model)) < m_c and draining:
            draining.pop(0).state = RUNNING  # revive
        while len(self.running(model)) < m_c and self.can_spawn(model):
            self.spawn(model)
        return len(self.running(model))

    def set_slot_cap(self, model: str, b: int) -> None:
        """The b axis on a live engine: cap concurrently-active slots per
        instance at ``min(b, max_slots)`` (the router enforces it)."""
        self.slot_caps[model] = max(1, min(b, self.max_slots))

    def set_token_budget(self, model: str, budget: Optional[int]) -> None:
        """The third knob: per-iteration cap on prefill-chunk + decode
        tokens for every live engine of ``model`` and future spawns.
        ``None`` (or 0) lifts the cap."""
        budget = budget or None
        self.token_budgets[model] = budget
        for inst in self.instances[model]:
            if inst.engine is not None:
                inst.engine.token_budget = budget

    def set_spec_k(self, model: str, k: int) -> None:
        """The fourth knob: the speculation depth of every live engine of
        ``model`` and of future spawns, clamped per engine to the depth it
        was built for (``spec_max``; 0 for an engine built without
        speculation), so the call is safe for any model."""
        k = max(0, k)
        self.spec_ks[model] = k
        for inst in self.instances[model]:
            if inst.engine is not None:
                inst.engine.spec_k = min(k, inst.engine.spec_max)

    def prefill_backlog_tokens(self, model: Optional[str] = None) -> int:
        """Prompt tokens queued or mid-chunk across the live instances of
        ``model`` (or all models)."""
        return sum(i.engine.prefill_backlog_tokens
                   for i in self.live(model))

    def _sweep(self) -> None:
        """DRAINING instances with no resident work -> RETIRED; the engine
        (its KV cache) is dropped so the memory really frees, and its
        block grant returns to the shared budget."""
        for model, lst in self.instances.items():
            keep = []
            retired_any = False
            for inst in lst:
                if inst.state == DRAINING and inst.n_resident == 0:
                    inst.state = RETIRED
                    retired_any = True
                    inst.engine_stats = inst.engine.stats()
                    inst.engine = None
                    if self.kv_blocks_free is not None:
                        self.kv_blocks_free += inst.kv_blocks
                    inst.kv_blocks = 0
                    self.retired.append(inst)
                else:
                    keep.append(inst)
            self.instances[model] = keep
            if not keep:
                # last instance gone: drop the weight donors of every
                # degree (the weights free unless ``load_params`` holds
                # them)
                for key in [k for k in self._templates if k[0] == model]:
                    self._templates.pop(key)
                if retired_any:
                    # preemption bookkeeping dies with the last instance:
                    # a respawned model starts outside any cooldown
                    self.preempts_by_model[model] = 0
                    self._last_preempt_step.pop(model, None)

    # ---- router ----------------------------------------------------------
    def submit(self, model: str, prompt: np.ndarray, slo_ms: float = 1000.0,
               max_new_tokens: int = 8,
               submit_s: Optional[float] = None) -> int:
        if model not in self.configs:
            raise KeyError(f"unknown model {model!r}; "
                           f"pool serves {sorted(self.configs)}")
        rid = self._next_rid
        self._next_rid += 1
        req = PoolRequest(rid, model, np.asarray(prompt, np.int32), slo_ms,
                          max_new_tokens,
                          self.now() if submit_s is None else submit_s)
        req.lifecycle = RequestLifecycle(rid, req.submit_s)
        heapq.heappush(self.queues[model],
                       (req.deadline_s, next(_seq), req))
        return rid

    # ---- cancellation ----------------------------------------------------
    def _dequeue(self, model: str, request_id: int
                 ) -> Optional[PoolRequest]:
        """Remove ``request_id`` from the model's EDF queue at once
        (swap-pop and re-heapify), so a cancelled head never blocks the
        requests behind it."""
        q = self.queues[model]
        for qi, (_, _, req) in enumerate(q):
            if req.request_id == request_id:
                q[qi] = q[-1]
                q.pop()
                heapq.heapify(q)
                return req
        return None

    def cancel(self, request_id: int) -> Optional[PoolResult]:
        """Tear ``request_id`` down wherever it lives (the EDF queue, a
        preempted snapshot awaiting re-admission included, an engine's
        waiting list, a mid-prefill or a decoding slot), freeing its
        blocks before returning. Returns the cancelled ``PoolResult``
        with its partial tokens, or ``None`` when the id is unknown or
        already terminal (a cancel after finish is a no-op)."""
        for model in self.queues:
            req = self._dequeue(model, request_id)
            if req is not None:
                # a preempted snapshot carries its earlier tokens
                snap = req.resume
                if snap is not None and snap.swapped:
                    # it will never resume: its host blocks go back to
                    # the source engine (nothing to free once that engine
                    # retired: the host pool went with it)
                    src = self._swap_source(model, snap)
                    if src is not None:
                        src.engine.allocator.host_free(snap.host_blocks)
                    tokens = np.asarray(snap.tokens, np.int32)
                elif snap is not None:
                    tokens = np.asarray(snap.seq_tokens[snap.base_len:],
                                        np.int32)
                else:
                    tokens = np.zeros((0,), np.int32)
                return self._finish_cancel(req, None, tokens)
        for inst in self.live():
            for erid, req in list(inst.requests.items()):
                if req.request_id != request_id:
                    continue
                r = inst.engine.cancel(erid)
                if r is None:  # the engine finished it this step
                    return None
                inst.requests.pop(erid, None)
                return self._finish_cancel(req, inst, r.tokens)
        return None

    def _finish_cancel(self, req: PoolRequest,
                       inst: Optional[ModelInstance],
                       tokens: np.ndarray) -> PoolResult:
        now = self.now()
        res = PoolResult(req.request_id, req.model,
                         inst.instance_id if inst is not None else -1,
                         tokens, req.submit_s, req.admit_s, now,
                         req.slo_ms, utility=0.0, cancelled=True,
                         first_token_s=req.first_token_s)
        self.n_cancelled += 1
        self._results[req.model].append(res)
        if req.lifecycle is not None and not req.lifecycle.terminal:
            req.lifecycle.to(lifecycle.CANCELLED, now)
        self._emit(req, "cancelled", tokens=[int(t) for t in tokens])
        self._listeners.pop(req.request_id, None)
        return res

    def queue_len(self, model: str) -> int:
        return len(self.queues[model])

    def admission_headroom(self, model: str, prompt_len: int,
                           max_new_tokens: int) -> Dict[str, float]:
        """Backpressure signal for a front-end: could a request of this
        shape start NOW (the engines' real admission gate under the slot
        cap), and if not, when is it worth retrying? ``retry_after_s``
        prices the queued work (prefill backlog, queued requests'
        footprints and this request's own) with the calibrated per-token
        iteration cost, or a queue-depth heuristic before calibration."""
        cap = self.slot_caps[model]
        admissible_now = any(
            cap - i.n_resident > 0
            and i.engine.admissible(prompt_len, max_new_tokens)
            for i in self.running(model))
        qdepth = len(self.queues[model])
        backlog = self.prefill_backlog_tokens(model)

        def _queued_work(r: PoolRequest) -> int:
            if r.resume is None:
                return len(r.prompt) + r.max_new_tokens
            # a preempted snapshot owes its remaining decode tokens plus,
            # recomputed, the re-prefill of its whole context (a swapped
            # one maps its context back)
            ctx = 0 if r.resume.swapped else len(r.resume.seq_tokens)
            return ctx + r.resume.max_new

        queued_tokens = sum(_queued_work(r)
                            for _, _, r in self.queues[model])
        work = backlog + queued_tokens
        if not admissible_now:
            work += prompt_len + max_new_tokens
        base, per_tok = self.token_cost()
        if per_tok > 0.0:
            retry_s = (base + work * per_tok) / 1000.0
        else:
            retry_s = 0.05 * (1 + qdepth)
        return {
            "admissible_now": float(admissible_now),
            "queue_depth": float(qdepth),
            "backlog_tokens": float(backlog + queued_tokens),
            "retry_after_s": float(min(max(retry_s, 0.05), 30.0)),
        }

    def oldest_slack_ms(self, model: str) -> float:
        """Remaining SLO budget of the most urgent waiting request."""
        if not self.queues[model]:
            return float("inf")
        return (self.queues[model][0][0] - self.now()) * 1000.0

    def _request_blocks(self, eng: ContinuousBatchingEngine,
                        req: PoolRequest) -> int:
        """Worst-case block need of ``req`` on ``eng``: the resumed context
        for a preempted sequence, the fresh prompt's shape otherwise."""
        if req.resume is not None:
            return eng.resume_blocks(req.resume)
        return eng.request_blocks(len(req.prompt), req.max_new_tokens)

    def _never_admissible(self, model: str, req: PoolRequest) -> bool:
        """True when ``req``'s worst-case block reservation exceeds every
        grant this pool could field for ``model`` (the largest live
        instance and a future spawn's grant): the router rejects it
        instead of letting it block the EDF queue forever."""
        if self.kv_layout != "paged":
            return False
        insts = self.running(model)
        if not insts:
            return False
        need = self._request_blocks(insts[0].engine, req)
        cap = max(i.engine.allocator.n_blocks for i in insts)
        return need > max(cap, self._spawn_grant())

    # ---- SLO-aware preemption -------------------------------------------
    def _try_preempt(self, model: str, req: PoolRequest,
                     now: float) -> bool:
        """Preempt one resident of ``model`` to make room for the urgent
        waiting request ``req``. Fires only when (a) no instance can admit
        ``req``, (b) its slack no longer covers its predicted service time
        (the calibrated contention model), and (c) a victim exists whose
        slack exceeds the urgent slack by the margin, that was not
        preempted too often already, is not mid-chunk prefill, and whose
        eviction makes ``req`` admissible. At most one preemption per
        model per cooldown window."""
        last = self._last_preempt_step.get(model)
        if last is not None and \
                self.n_steps - last < self.preempt_cooldown_steps:
            return False
        t1, c = self.contention()
        if t1 <= 0.0:
            return False  # uncalibrated: no service-time prediction yet
        need_ms = req.max_new_tokens * lm.predicted_iter_ms(
            t1, c, max(1, self.busy_count()))
        slack_ms = (req.deadline_s - now) * 1000.0
        if slack_ms >= need_ms:
            return False  # not urgent: waiting for an eviction is fine
        best = None
        for inst in self.running(model):
            eng = inst.engine
            if req.resume is not None and req.resume.swapped \
                    and id(eng) != req.resume.host_engine_id:
                continue  # a swapped head fits only its source engine
            for slot, erid, freeable in eng.preemption_candidates():
                vreq = inst.requests.get(erid)
                if vreq is None or vreq.n_preempted >= self.max_preemptions:
                    continue
                vslack_ms = (vreq.deadline_s - now) * 1000.0
                if vslack_ms <= slack_ms + self.preempt_margin_ms:
                    continue  # hysteresis: the victim must be clearly laxer
                if self.kv_layout == "paged" and \
                        eng.allocator.n_available + freeable \
                        < self._request_blocks(eng, req):
                    continue  # eviction would not make req admissible
                if best is None or vslack_ms > best[0]:
                    best = (vslack_ms, inst, slot, erid)
        if best is None:
            return False
        _, inst, slot, erid = best
        mode = self._pick_preempt_mode(inst.engine, slot)
        snapshot = inst.engine.preempt(slot, requeue=False, mode=mode)
        vreq = inst.requests.pop(erid)
        vreq.resume = snapshot
        vreq.n_preempted += 1
        if mode == "swap":
            self.n_swap_preempted += 1
        if vreq.lifecycle is not None and not vreq.lifecycle.terminal:
            # DECODE -> QUEUED, marked with how: swapped KV waits in the
            # host tier, a recompute snapshot re-prefills
            vreq.lifecycle.to(lifecycle.QUEUED, now,
                              swapped=mode == "swap")
        self._emit(vreq, "preempted", instance_id=inst.instance_id,
                   swapped=mode == "swap")
        heapq.heappush(self.queues[model],
                       (vreq.deadline_s, next(_seq), vreq))
        self.n_preempted += 1
        self.preempts_by_model[model] += 1
        self._last_preempt_step[model] = self.n_steps
        return True

    def _pick_preempt_mode(self, eng: ContinuousBatchingEngine,
                           slot: int) -> str:
        """Recompute or swap, a priced choice. Recompute re-prefills the
        victim's context on resume: the token-cost fit at ``pos`` tokens.
        Swap pays two transfers (out now, in at resume): the swap-cost fit
        at the victim's blocks. Until both fits are calibrated, swap
        wherever the host tier has room: a transfer is the only way to
        collect swap samples."""
        if self.preempt_mode == "recompute" or not eng.can_swap(slot):
            return "recompute"
        if self.preempt_mode == "swap":
            return "swap"
        pos = int(eng.pos[slot])
        base, per_tok = self.token_cost()
        swap_base, per_mb = self.swap_cost()
        if per_tok <= 0.0 or per_mb <= 0.0:
            return "swap"
        recompute_ms = base + pos * per_tok
        mb = len(eng.slots[slot].blocks) * eng.swap_bytes_per_block / 1e6
        swap_ms = 2.0 * lm.predicted_swap_ms(swap_base, per_mb, mb)
        return "swap" if swap_ms < recompute_ms else "recompute"

    def swap_cost(self) -> Tuple[float, float]:
        """Calibrated ``(base_ms, ms_per_mb)`` of a host-tier transfer over
        every live engine's (bytes, ms) samples
        (``latency_model.fit_swap_cost``); ``(0, 0)`` before four
        samples."""
        samples: List[Tuple[int, float]] = []
        for i in self.live():
            samples.extend(i.engine.swap_samples[-_SAMPLE_WINDOW:])
        if len(samples) < 4:
            return 0.0, 0.0
        return lm.fit_swap_cost(samples[-_SAMPLE_WINDOW:])

    def _swap_source(self, model: str,
                     snap: PreemptedRequest) -> Optional[ModelInstance]:
        """The instance whose engine's host pool holds ``snap``'s blocks
        (None once it retired)."""
        for inst in self.instances[model]:
            if inst.engine is not None \
                    and id(inst.engine) == snap.host_engine_id:
                return inst
        return None

    def _repin_swap(self, model: str, req: PoolRequest) -> None:
        """A swap snapshot resumes only on the engine holding its host
        blocks. When that engine drains or is gone, turn the snapshot back
        into a recompute one so the request stays routable: releasing the
        host blocks while the engine exists, else rebuilding it from the
        carried tokens (the host pool went with the engine)."""
        snap = req.resume
        if snap is None or not snap.swapped:
            return
        src = self._swap_source(model, snap)
        if src is None:
            req.resume = to_recompute(snap)
        elif src.state != RUNNING:
            req.resume = src.engine.release_swap(snap)

    def _reject(self, req: PoolRequest) -> PoolResult:
        now = self.now()
        res = PoolResult(req.request_id, req.model, -1,
                         np.zeros((0,), np.int32), req.submit_s, now, now,
                         req.slo_ms, utility=0.0, rejected=True)
        self.n_rejected += 1
        self._results[req.model].append(res)
        if req.lifecycle is not None and not req.lifecycle.terminal:
            req.lifecycle.to(lifecycle.REJECTED, now)
        self._emit(req, "rejected", slo_ms=req.slo_ms)
        self._listeners.pop(req.request_id, None)
        return res

    def route(self) -> List[PoolResult]:
        """Admit waiting requests, earliest absolute deadline first, into
        the least-loaded RUNNING instance of their model; under
        ``strict_admission`` requests that can no longer meet their
        deadline are rejected instead of taking a slot, and under
        ``preemption`` an urgent head no instance can admit may evict a
        laxer resident (``_try_preempt``). A preempted request resumes
        through ``submit_resume``. Returns the rejections."""
        rejected: List[PoolResult] = []
        now = self.now()
        t1, c = self.contention()
        #: blocks promised to requests routed THIS pass that their engine
        #: has not reserved yet (reservation happens inside engine.admit,
        #: at the next iteration boundary)
        pending: Dict[int, int] = {}
        for model, q in self.queues.items():
            cap = self.slot_caps[model]
            open_insts = [i for i in self.running(model)
                          if cap - i.n_resident > 0]
            while q:
                deadline_s, _, req = q[0]
                # a swap snapshot whose source drained or retired becomes
                # a recompute one before any admission question
                self._repin_swap(model, req)
                if self.strict_admission:
                    hopeless = now > deadline_s
                    if not hopeless and t1 > 0.0:
                        need_ms = req.max_new_tokens * lm.predicted_iter_ms(
                            t1, c, max(1, self.busy_count() + 1))
                        hopeless = now + need_ms / 1000.0 > deadline_s
                    if hopeless:
                        heapq.heappop(q)
                        rejected.append(self._reject(req))
                        continue

                def _open():
                    return [i for i in self.running(model)
                            if cap - i.n_resident > 0]

                def _cands():
                    insts = open_insts
                    if req.resume is not None and req.resume.swapped:
                        # swapped KV sits in one engine's host pool
                        insts = [i for i in insts if id(i.engine)
                                 == req.resume.host_engine_id]
                    # paged engines additionally gate on free KV blocks
                    return [i for i in insts
                            if i.engine.admissible(
                                len(req.prompt), req.max_new_tokens,
                                pending.get(i.instance_id, 0),
                                resume=req.resume, prompt=req.prompt)]

                cands = _cands() if open_insts else []
                if not cands and self.preemption and \
                        self._try_preempt(model, req, now):
                    # the victim's slot and blocks freed synchronously;
                    # its instance may admit the urgent request now
                    open_insts = _open()
                    cands = _cands()
                if not open_insts and not cands:
                    break
                if not cands:
                    if self._never_admissible(model, req):
                        heapq.heappop(q)
                        rejected.append(self._reject(req))
                        continue
                    break
                if self.prefix_cache:
                    # prefix affinity: prefer the instance whose cache
                    # holds the request's prefix (hit tokens first, the
                    # least loaded as the tie-break), so shared prompts
                    # concentrate instead of prefilling on every instance
                    inst = max(cands, key=lambda i: (
                        i.engine.cached_prefix_tokens(
                            req.resume.seq_tokens if req.resume is not None
                            else req.prompt,
                            prepadded=req.resume is not None),
                        cap - i.n_resident))
                else:
                    inst = max(cands, key=lambda i: cap - i.n_resident)
                heapq.heappop(q)
                if self.kv_layout == "paged":
                    pending[inst.instance_id] = \
                        pending.get(inst.instance_id, 0) \
                        + self._request_blocks(inst.engine, req)
                if req.resume is not None:
                    erid = inst.engine.submit_resume(req.resume)
                    req.resume = None
                else:
                    erid = inst.engine.submit(req.prompt,
                                              req.max_new_tokens)
                req.admit_s = now
                inst.requests[erid] = req
                self.admission_log.append((req.request_id,
                                           inst.instance_id))
                if cap - inst.n_resident <= 0:
                    open_insts.remove(inst)
        return rejected

    # ---- iteration -------------------------------------------------------
    def _finish(self, inst: ModelInstance,
                r: ContinuousResult) -> PoolResult:
        req = inst.requests.pop(r.request_id)
        now = self.now()
        hist = self._results[req.model]
        # throughput term of Eq. 3: this model's completions per second
        # over a recent window that spans at least this request's own
        # lifetime
        recent = [x.finish_s for x in hist[-32:] if not x.rejected] + [now]
        span_s = max(now - min(recent), now - req.submit_s, 1e-3)
        thr = len(recent) / span_s
        u = utility(max(thr, 1e-3), max(now - req.submit_s, 1e-4),
                    req.slo_ms / 1000.0, max(1, self.m_c(req.model)))
        res = PoolResult(req.request_id, req.model, inst.instance_id,
                         r.tokens, req.submit_s, req.admit_s, now,
                         req.slo_ms, utility=0.0 if r.cancelled else u,
                         cancelled=bool(r.cancelled),
                         first_token_s=req.first_token_s)
        hist.append(res)
        # cancelled results stay out of the client timings: a disconnect
        # storm's partial timings would drag the percentiles down
        if res.first_token_s >= 0 and not res.cancelled:
            self.ttft_samples.append(res.ttft_ms)
            if res.tpot_ms >= 0:
                self.tpot_samples.append(res.tpot_ms)
            if len(self.ttft_samples) > 2 * _SAMPLE_WINDOW:
                del self.ttft_samples[:-_SAMPLE_WINDOW]
            if len(self.tpot_samples) > 2 * _SAMPLE_WINDOW:
                del self.tpot_samples[:-_SAMPLE_WINDOW]
        if res.cancelled:
            self.n_cancelled += 1
        if req.lifecycle is not None and not req.lifecycle.terminal:
            req.lifecycle.to(lifecycle.CANCELLED if res.cancelled
                             else lifecycle.FINISHED, now)
        self._emit(req, "finished", tokens=[int(t) for t in r.tokens],
                   latency_ms=res.latency_ms, utility=u,
                   truncated=bool(r.truncated),
                   n_preempted=int(r.n_preempted))
        self._listeners.pop(req.request_id, None)
        return res

    def step(self) -> List[PoolResult]:
        """One pool iteration: sweep retirements, route admissions, then
        run ONE iteration on every busy live instance. Returns the
        requests that finished (or were rejected) this iteration.

        The wall time of the whole iteration is what a resident sequence
        waits per token, so that is what the contention model calibrates
        against the overlap level (pure-decode iterations only) and the
        token-cost model against the tokens processed. Each engine's
        step reads its sampled tokens back to the host, so the time
        covers the device's work; the pool adds no synchronisation."""
        self._sweep()
        out: List[PoolResult] = list(self.route())
        busy = [i for i in self.live()
                if i.engine.active_slots or i.engine.waiting]
        if not busy:
            self.n_steps += 1
            return out
        overlap = len(busy)
        pure_decode = not any(i.engine.prefill_backlog_tokens
                              for i in busy)
        t0 = time.perf_counter()
        for inst in busy:
            for r in inst.engine.step():
                out.append(self._finish(inst, r))
        iter_ms = (time.perf_counter() - t0) * 1000.0
        compiled = any(i.engine.last_step_compiled for i in busy)
        if not compiled:
            sample = (sum(i.engine.last_step_tokens for i in busy), iter_ms)
            self.token_samples.append(sample)
            if len(self.token_samples) > 2 * _SAMPLE_WINDOW:
                del self.token_samples[:-_SAMPLE_WINDOW]
            degrees = {i.tp_degree for i in busy}
            if len(degrees) == 1:
                # one degree only: the sample prices that layout
                bucket = self.tp_token_samples.setdefault(degrees.pop(), [])
                bucket.append(sample)
                if len(bucket) > 2 * _SAMPLE_WINDOW:
                    del bucket[:-_SAMPLE_WINDOW]
        if pure_decode and not compiled:
            self.contention_samples.append((overlap, iter_ms))
            self.occupancy_samples.append(
                (sum(i.n_resident for i in busy),
                 sum(i.engine.kv_used_tokens for i in busy)))
            if len(self.contention_samples) > 2 * _SAMPLE_WINDOW:
                del self.contention_samples[:-_SAMPLE_WINDOW]
            if len(self.occupancy_samples) > 2 * _SAMPLE_WINDOW:
                del self.occupancy_samples[:-_SAMPLE_WINDOW]
        if self.predictor is not None and pure_decode:
            for inst in busy:
                self.predictor.observe(
                    engine_features(self.configs[inst.model],
                                    self.m_c(inst.model),
                                    inst.n_resident, overlap),
                    iter_ms / 1000.0)
        self.n_steps += 1
        return out

    def _work_pending(self) -> bool:
        return any(self.queues.values()) \
            or any(i.n_resident for i in self.live())

    def _can_progress(self) -> bool:
        """Something is resident on a live instance, or a queued model has
        a RUNNING instance to route to."""
        if any(i.n_resident for i in self.live()):
            return True
        return any(q and self.running(m) for m, q in self.queues.items())

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> List[PoolResult]:
        """Step until every queue and instance is empty. Raises
        ``RuntimeError`` when ``max_steps`` runs out with work pending;
        queued work whose model has no RUNNING instance returns normally
        (it cannot progress until the caller scales up)."""
        done: List[PoolResult] = []
        while max_steps > 0 and self._work_pending():
            if not self._can_progress():
                break
            done.extend(self.step())
            max_steps -= 1
        self._sweep()
        if self._work_pending() and self._can_progress():
            queued = {m: len(q) for m, q in self.queues.items() if q}
            resident = sum(i.n_resident for i in self.live())
            raise RuntimeError(
                f"run_until_drained: max_steps exhausted with work still "
                f"pending (queued={queued}, resident={resident})")
        return done

    def warmup(self, prompt_lens: Tuple[int, ...] = (8, 20),
               seed: int = 0) -> None:
        """One prompt per length per model with instances (at an
        effectively infinite SLO), drained, then metrics reset: first-use
        costs (kernel builds and loads, library handles) pollute neither
        the SLO stats nor the contention fit."""
        rng = np.random.default_rng(seed)
        submitted = False
        for m, cfg in self.configs.items():
            if self.m_c(m) == 0:
                continue
            for n in prompt_lens:
                self.submit(m, rng.integers(1, cfg.vocab_size, n).astype(
                    np.int32), slo_ms=600_000.0, max_new_tokens=2)
                submitted = True
        if submitted:
            self.run_until_drained()
        self.reset_metrics()

    # ---- accounting ------------------------------------------------------
    def reset_metrics(self) -> None:
        """Clear serving metrics (results, admission log, counters,
        calibration samples) but keep the instances."""
        self._results = {m: [] for m in self.configs}
        self.admission_log = []
        self.contention_samples = []
        self.occupancy_samples = []
        self.token_samples = []
        self.tp_token_samples = {}
        self.ttft_samples = []
        self.tpot_samples = []
        self.n_rejected = 0
        self.n_cancelled = 0
        self.n_preempted = 0
        self.n_swap_preempted = 0
        self.preempts_by_model = {m: 0 for m in self.configs}
        self._last_preempt_step = {}
        self.n_steps = 0
        self._t0 = time.perf_counter()

    def contention(self) -> Tuple[float, float]:
        """Calibrated ``(t1_ms, c)`` (``latency_model.fit_contention``);
        ``(0, 0)`` before eight samples."""
        if len(self.contention_samples) < 8:
            return 0.0, 0.0
        return lm.fit_contention(self.contention_samples[-_SAMPLE_WINDOW:])

    def token_cost(self, tp_degree: Optional[int] = None
                   ) -> Tuple[float, float]:
        """Calibrated ``(base_ms, per_token_ms)`` iteration-cost model
        (``latency_model.fit_token_cost``); ``(0, 0)`` before eight
        samples. ``tp_degree`` selects that degree's fit, where it has
        eight samples; otherwise the global one."""
        if tp_degree is not None:
            bucket = self.tp_token_samples.get(tp_degree, [])
            if len(bucket) >= 8:
                return lm.fit_token_cost(bucket[-_SAMPLE_WINDOW:])
        if len(self.token_samples) < 8:
            return 0.0, 0.0
        return lm.fit_token_cost(self.token_samples[-_SAMPLE_WINDOW:])

    def kv_used_tokens(self, model: Optional[str] = None) -> int:
        """Σ cache tokens resident sequences occupy right now, over the
        live instances of ``model`` (or all models)."""
        return sum(i.engine.kv_used_tokens for i in self.live(model))

    def occupancy_tokens_per_seq(self) -> float:
        """Measured mean KV tokens per resident sequence
        (``latency_model.fit_occupancy``); 0.0 before eight samples."""
        if len(self.occupancy_samples) < 8:
            return 0.0
        return lm.fit_occupancy(self.occupancy_samples[-_SAMPLE_WINDOW:])

    def prefix_hit_rate(self) -> float:
        """Prompt tokens served from prefix caches as a fraction of all
        prompt tokens processed, over the live instances: a scheduler
        state feature."""
        live = self.live()
        hit = sum(i.engine.n_prefix_hit_tokens for i in live)
        total = hit + sum(i.engine.n_prefill_chunk_tokens for i in live)
        return hit / total if total else 0.0

    def spec_accept_rate(self) -> float:
        """Drafts accepted over drafts proposed, over the live instances:
        the scheduler's feature behind the k axis (0.0 before any
        speculative step)."""
        live = self.live()
        acc = sum(i.engine.n_spec_accepted for i in live)
        prop = sum(i.engine.n_spec_proposed for i in live)
        return acc / prop if prop else 0.0

    def kv_shared_frac(self) -> float:
        """Fraction of live block mappings backed by a block another
        resident sequence also maps: 0 without a prefix cache. The guard
        prices effective blocks with it (a shared block charges the
        budget once)."""
        logical = distinct = 0
        for i in self.live():
            if i.engine.kv_layout != "paged":
                continue
            lg, d = i.engine.kv_block_mapping()
            logical += lg
            distinct += d
        return 1.0 - distinct / logical if logical else 0.0

    def kv_occupancy(self) -> Dict[str, float]:
        """Real occupancy of the shared KV budget and of the paged
        engines' host tiers: what the ``PoolScheduler``'s memory guard,
        headroom and host features read. Budget fields are 0 for
        unlimited budgets, host fields 0 without a host tier."""
        budget_blocks = self.kv_block_budget or 0
        host_blocks = host_free = host_live = host_cached = 0
        for i in self.live():
            if i.engine.kv_layout != "paged":
                continue
            a = i.engine.allocator
            host_blocks += a.n_host_blocks
            host_free += a.n_host_free
            host_live += a.n_host_live
            host_cached += a.n_host_cached
        return {
            "used_tokens": float(self.kv_used_tokens()),
            "allocated_tokens": float(sum(
                i.engine.kv_allocated_tokens for i in self.live())),
            "budget_tokens": float(budget_blocks * self.block_size),
            "free_blocks": float(self.kv_blocks_free or 0),
            "committed_blocks": float(sum(i.kv_blocks
                                          for i in self.live())),
            "tokens_per_seq": self.occupancy_tokens_per_seq(),
            "shared_frac": self.kv_shared_frac(),
            "prefix_hit_rate": self.prefix_hit_rate(),
            "host_blocks": float(host_blocks),
            "host_free": float(host_free),
            "host_live": float(host_live),
            "host_cached": float(host_cached),
            "host_frac": float((host_live + host_cached) / host_blocks)
            if host_blocks else 0.0,
        }

    def slot_ms(self, model: str) -> float:
        """Eq. 1 for the live allocation: t_i = Σ SLO of the model's
        resident requests / m_c; the PoolScheduler re-decides once per
        slot."""
        slo_sum = sum(i.slo_sum_ms for i in self.live(model))
        return slo_sum / max(1, self.m_c(model))

    def results(self, model: str) -> List[PoolResult]:
        """All finished/rejected results for ``model`` so far."""
        return list(self._results[model])

    def states(self, model: str) -> List[str]:
        return [i.state for i in self.instances[model]] + \
            [i.state for i in self.retired if i.model == model]

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-model serving metrics over the pool's lifetime."""
        out: Dict[str, Dict[str, float]] = {}
        for model, results in self._results.items():
            # cancelled requests left on their client's initiative: they
            # are reported, but neither served nor violated
            considered = [r for r in results if not r.cancelled]
            served = [r for r in considered if not r.rejected]
            viol = sum(1 for r in considered if r.violated)
            lats = [r.latency_ms for r in served]
            out[model] = {
                "served": float(len(served)),
                "rejected": float(len(considered) - len(served)),
                "cancelled": float(len(results) - len(considered)),
                "violations": float(viol),
                "slo_attainment": 1.0 - viol / max(1, len(considered)),
                "mean_latency_ms": float(np.mean(lats)) if lats else 0.0,
                "mean_utility": float(np.mean(
                    [r.utility for r in served])) if served else 0.0,
                "generated_tokens": float(sum(len(r.tokens)
                                              for r in served)),
                "m_c": float(self.m_c(model)),
                "tp_degree": float(self.tp_degrees.get(model, 1)),
                "queued": float(len(self.queues[model])),
                "preempted": float(self.preempts_by_model.get(model, 0)),
            }
        return out

    def stats(self) -> Dict[str, float]:
        t1, c = self.contention()
        base, per_tok = self.token_cost()
        swap_base, per_mb = self.swap_cost()
        out = {
            "n_steps": float(self.n_steps),
            "live_instances": float(self.total_live()),
            "devices_in_use": float(self.devices_in_use()),
            "retired_instances": float(len(self.retired)),
            "n_rejected": float(self.n_rejected),
            "n_cancelled": float(self.n_cancelled),
            "n_preempted": float(self.n_preempted),
            "n_swap_preempted": float(self.n_swap_preempted),
            "prefill_backlog_tokens": float(self.prefill_backlog_tokens()),
            "contention_t1_ms": t1,
            "contention_c": c,
            "token_base_ms": base,
            "token_per_ms": per_tok,
            "swap_base_ms": swap_base,
            "swap_ms_per_mb": per_mb,
            "spec_accept_rate": self.spec_accept_rate(),
            "ttft_ms_p50": float(np.percentile(self.ttft_samples, 50))
            if self.ttft_samples else 0.0,
            "ttft_ms_p99": float(np.percentile(self.ttft_samples, 99))
            if self.ttft_samples else 0.0,
            "tpot_ms_p50": float(np.percentile(self.tpot_samples, 50))
            if self.tpot_samples else 0.0,
            "tpot_ms_p99": float(np.percentile(self.tpot_samples, 99))
            if self.tpot_samples else 0.0,
        }
        if self.kv_layout == "paged" or self.kv_block_budget:
            out.update({f"kv_{k}": v for k, v in self.kv_occupancy().items()})
        return out
