"""Inference engines: the port of ``repro.serving.engine``'s round-based
``InferenceEngine`` and its ``ContinuousBatchingEngine`` with the dense
and the paged KV layout.

* ``InferenceEngine`` — the paper's round semantics (§IV-D): a batch of
  left-padded prompts is prefilled in one shot (``Model.prefill``, the
  flash attention kernel on the card) and decoded in lock step for a
  fixed number of tokens over a dense per-round cache.
* ``ContinuousBatchingEngine`` — iteration-level batching: a fixed number
  of slots is decoded one token per ``step()``; finished sequences are
  evicted at iteration boundaries and queued prompts are prefilled in
  budget-bounded chunks. ``kv_layout="paged"`` writes the chunks straight
  into a shared block pool through each slot's block table
  (docs/ARCHITECTURE.md §5); ``kv_layout="dense"`` chunks into a per-slot
  staging cache and grafts it into the slot's row of a dense
  ``(n_slots, cache_len)`` cache when the prompt is done.

On the card the attention of every layer runs the hand-written kernels
(``repro_torch.kernels``); on the CPU their plain versions.

Both engines serve the attention, the recurrent (RG-LRU, RWKV-6) and the
MoE families; a recurrent layer's per-slot state sits beside the K/V rows
of the dense layout and is grafted with them. An MoE layer's capacity
follows the rows of each forward, as in the reference: all ``n_slots``
rows of a decode iteration (idle slots' dummy tokens included), the
unpadded rows of a prefill chunk, and every row of a round's left-padded
``(B, S)`` batch.

For the instance pool (``serving/runtime.py``) the continuous engine
shares one model and params dict between instances (``share_from``),
reports per-token and phase events (``on_token``, ``on_state``), counts
each step's tokens and whether it loaded a kernel library
(``last_step_tokens``, ``last_step_compiled``), and prices admission
(``request_blocks``, ``admissible``, ``kv_block_mapping``).

Preemption (recompute: the snapshot re-prefills the padded prompt plus
every emitted token on resume) and cancellation at any phase are ported,
and so is seeded sampling, which draws from its own ``torch.Generator``
and so matches the reference in distribution, not token for token.
What is still to port raises (see ROADMAP.md): the prefix cache,
speculative decoding, the host KV tier (and with it preemption by
swap), tensor parallelism, windowed and recurrent layers under the paged
layout, and encoder-decoder and frontend models.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.transformer import (check_paged_supported,
                                            check_supported, pad_cache)


def _bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128)) -> int:
    for b in buckets:
        if n <= b:
            return b
    # clamping here would silently under-count S downstream (the cache-fit
    # check in ContinuousBatchingEngine.submit would pass for prompts that
    # do not fit), so over-length input is an error at the boundary
    raise ValueError(
        f"size {n} exceeds the largest bucket {buckets[-1]}")


SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 640)

#: largest chunked-prefill piece; pieces are powers of two up to this
_MAX_CHUNK = 512


def _categorical(logits: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (..., V) by the
    Gumbel-max trick, as ``jax.random.categorical`` draws, with uniforms
    from ``gen`` (which lives on the logits' device)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def sample_tokens(logits: torch.Tensor, greedy: bool = True,
                  seed: int = 0) -> np.ndarray:
    """Next tokens from ``logits`` (..., V) over the trailing vocabulary
    axis: the argmax when ``greedy`` (the first index on ties, as
    ``jnp.argmax``; the deterministic path every engine's token identity
    rests on), else a categorical draw seeded by ``seed``, the same draws
    for the same seed. torch's generator cannot reproduce
    ``jax.random``'s bits, so a sampled token equals the reference's in
    distribution only. Returns an int32 ndarray shaped
    ``logits.shape[:-1]``."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    return _categorical(logits, _generator(logits.device, seed)
                        ).cpu().numpy()


def make_prefill_batch(cfg: ModelConfig, prompts: List[np.ndarray]
                       ) -> Tuple[Dict[str, np.ndarray], int, np.ndarray]:
    """Left-pad ``prompts`` into a bucketed (B, S) int32 token batch:
    B the power-of-two bucket of the prompt count (extra rows all token
    0), S the ``SEQ_BUCKETS`` bucket of the longest prompt. The padding
    tokens are real positions the prompt attends, as in the reference.
    Returns ({"tokens": (B, S)}, S, prompt lengths (B,))."""
    B = _bucket(len(prompts))
    S = _bucket(max(len(p) for p in prompts), buckets=SEQ_BUCKETS)
    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p  # left-pad (last position = last token)
        lens[i] = len(p)
    return {"tokens": toks}, S, lens


@dataclasses.dataclass
class GenerationResult:
    """Output of one round-mode ``generate`` call (paper §IV-D round)."""
    tokens: np.ndarray          # (B, new)
    prefill_ms: float
    decode_ms: float
    total_ms: float


class InferenceEngine:
    """Round-based (run-to-completion) execution backend (paper §IV-D).

    ``generate`` runs one batch round: a bucketed one-shot prefill, then
    ``max_new_tokens`` lock-step greedy decode iterations for every
    request in the batch over a dense cache grown by ``pad_cache``.

    Runs on ``device`` (default ``"cuda"``, which raises without a GPU;
    pass ``device="cpu"`` for the kernels' plain versions). Weights are
    drawn from ``seed`` unless ``params`` (the port's layout) are given
    or :meth:`load_jax_params` carries the reference's across.
    """

    def __init__(self, cfg: ModelConfig, max_seq: int = 512,
                 dtype=torch.float32, seed: int = 0, device="cuda",
                 params: Optional[Dict] = None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq = max_seq
        self.model = build_model(cfg)
        self.params = self.model.init(seed, dtype, self.device) \
            if params is None else to_device(params, self.device)

    def load_jax_params(self, params_np: Dict) -> None:
        """Replace the weights with the reference's (its param pytree with
        numpy leaves; see ``repro_torch.models.bridge``)."""
        self.params = to_device(params_from_jax(params_np, self.cfg),
                                self.device)

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 8,
                 greedy: bool = True, seed: int = 0) -> GenerationResult:
        """Prefill ``prompts`` as one left-padded batch, then decode
        ``max_new_tokens`` tokens for each: greedy, or with ``greedy=False``
        drawn from one generator on the engine's device seeded by
        ``seed``, one draw per decode step (the reference splits its key
        once per step). The first token is the prefill's argmax either
        way, as in the reference. Sampled tokens match the reference's in
        distribution, not token for token (``sample_tokens``). Times are
        host-clock milliseconds up to the device finishing the work."""
        t0 = time.perf_counter()
        batch, S, _ = make_prefill_batch(self.cfg, prompts)
        tokens = torch.from_numpy(batch["tokens"]).to(self.device)
        B = tokens.shape[0]
        logits, cache = self.model.prefill(self.params, {"tokens": tokens})
        if self.device.type == "cuda":  # time the prefill, not its enqueue
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        cache = pad_cache(self.cfg, cache, max_new_tokens)
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        out = torch.empty((B, max_new_tokens), dtype=torch.int32,
                          device=self.device)
        # tokens stay on the device until the round ends: no host sync
        # per decoded token
        gen = None if greedy else _generator(self.device, seed)
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        for t in range(max_new_tokens):
            out[:, t] = tok
            logits, cache = self.model.decode_step(
                self.params, cache, {"tokens": tok[:, None], "pos": pos})
            if greedy:
                tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            else:
                tok = _categorical(logits[:, -1, :], gen)
            pos = pos + 1
        out = out.cpu().numpy()
        t2 = time.perf_counter()
        return GenerationResult(out[: len(prompts)], (t1 - t0) * 1e3,
                                (t2 - t1) * 1e3, (t2 - t0) * 1e3)


# =====================================================================
# continuous (iteration-level) batching
# =====================================================================
class BlockAllocator:
    """Free-list allocator over a paged KV block pool: the device tier of
    the reference's ``BlockAllocator`` without prefix-cache keys or the
    host tier, so every live block has exactly one owner.

    ``n_blocks`` usable blocks of ``block_size`` tokens; physical ids are
    1..n_blocks (id 0 is the null block inactive batch rows write into,
    never handed out). Admission *reserves* a sequence's worst-case block
    count up front, so the lazy per-decode-boundary ``alloc_reserved``
    can never fail mid-sequence; eviction frees the blocks and cancels
    the unfilled remainder of the reservation.

    Invariants (checked after every step in tests/test_torch_engine.py):
      * ``n_free + n_live == n_blocks`` (disjoint id sets);
      * ``n_available = n_free - n_reserved >= 0``;
      * the null block 0 is never allocated.
    ``free`` raises on an out-of-range id, a duplicate within one call or
    a double free: any of them would hand one block to two sequences.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError("need at least one usable block")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks, 0, -1))  # pop() -> low ids first
        self._outstanding: Set[int] = set()
        self.n_reserved = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._outstanding)

    @property
    def n_available(self) -> int:
        """Blocks neither live nor promised to an admitted slot."""
        return len(self._free) - self.n_reserved

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.block_size)

    def reserve(self, n: int) -> bool:
        """Promise ``n`` blocks to a sequence; False when they are not
        available (the caller keeps the request queued)."""
        if self.n_available < n:
            return False
        self.n_reserved += n
        return True

    def unreserve(self, n: int) -> None:
        assert 0 <= n <= self.n_reserved
        self.n_reserved -= n

    def alloc_reserved(self) -> int:
        """Convert one previously reserved block into a physical id."""
        assert self.n_reserved > 0, "alloc without reservation"
        self.n_reserved -= 1
        bid = self._free.pop()
        self._outstanding.add(bid)
        return bid

    def free(self, ids: List[int]) -> None:
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate block ids in free(): {ids}")
        for i in ids:
            if not 0 < i <= self.n_blocks:
                raise ValueError(
                    f"block id {i} outside 1..{self.n_blocks}")
            if i not in self._outstanding:
                raise ValueError(
                    f"double free of block {i}: not currently allocated")
        for i in ids:
            self._outstanding.discard(i)
            self._free.append(i)


@dataclasses.dataclass
class _Slot:
    """One KV-cache slot: the sequence prefilling or decoding in batch
    row i. An admitted sequence starts PREFILLING (``prefill_pos <
    len(seq_tokens)``), advances by budget-bounded chunks written
    straight into its blocks, and becomes DECODING once the last chunk
    lands."""
    request_id: int = -1
    remaining: int = 0          # tokens still to emit
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_s: float = 0.0
    admit_s: float = 0.0
    # physical blocks owned, and how many of the admission reservation
    # remain unallocated (alloc-on-decode-boundary)
    blocks: List[int] = dataclasses.field(default_factory=list)
    n_outstanding: int = 0
    # chunked prefill state machine
    seq_tokens: Optional[np.ndarray] = None  # padded prompt (+ resume ctx)
    base_len: int = 0           # padded-prompt length at first admission
    prefill_pos: int = 0        # tokens of seq_tokens processed so far
    #: dense layout: the one-slot cache the chunks prefill into
    staging: Optional[List[Dict]] = None
    requested_new: int = 0      # caller-requested max_new (pre-clamp)
    truncated: bool = False
    n_preempted: int = 0
    #: engine-clock time the first token landed, carried across
    #: preemption so TTFT reflects the original first token (-1 before
    #: any token)
    first_token_s: float = -1.0

    @property
    def active(self) -> bool:
        return self.request_id >= 0

    @property
    def prefilling(self) -> bool:
        return self.active and self.seq_tokens is not None \
            and self.prefill_pos < len(self.seq_tokens)


@dataclasses.dataclass
class PreemptedRequest:
    """Resumable snapshot of a preempted sequence.

    Recompute snapshots (``host_blocks is None``, the only kind this
    port's engine makes): ``seq_tokens`` holds the padded prompt plus
    every token emitted so far, re-prefilled in chunks on resume, so
    greedy output is token-identical to an uninterrupted run. The swap
    fields mirror the reference's snapshot of a sequence whose KV blocks
    went to a host tier; the port has no host tier yet (ROADMAP.md), and
    its engines refuse a swapped snapshot."""
    request_id: int
    seq_tokens: np.ndarray      # padded prompt (+ emitted, recompute only)
    base_len: int               # emitted tokens = seq_tokens[base_len:]
    max_new: int                # tokens still to emit
    submit_s: float
    requested_new: int
    truncated: bool
    n_preempted: int
    first_token_s: float = -1.0
    # ---- swap-mode state (None/unused for recompute snapshots) ----
    tokens: Optional[List[int]] = None   # emitted tokens (swap only)
    pos: int = -1                        # decode frontier at preemption
    pending_tok: int = 0                 # sampled-but-unwritten token
    host_blocks: Optional[List[int]] = None
    host_engine_id: int = 0              # id() of the owning engine

    @property
    def swapped(self) -> bool:
        return self.host_blocks is not None


def to_recompute(req: PreemptedRequest) -> PreemptedRequest:
    """Rebuild a swap snapshot as a recompute snapshot without touching
    any allocator: the context becomes the padded prompt plus the emitted
    tokens, and greedy re-prefill regenerates the dropped pending token.
    A recompute snapshot is returned as it is."""
    if not req.swapped:
        return req
    seq = np.concatenate([req.seq_tokens,
                          np.asarray(req.tokens, np.int32)])
    return PreemptedRequest(
        req.request_id, seq, base_len=req.base_len, max_new=req.max_new,
        submit_s=req.submit_s, requested_new=req.requested_new,
        truncated=req.truncated, n_preempted=req.n_preempted,
        first_token_s=req.first_token_s)


@dataclasses.dataclass
class _WaitingReq:
    """One queued admission: a fresh prompt, or (``prepadded``) a
    preempted sequence whose bucket padding is already baked in."""
    request_id: int
    prompt: np.ndarray
    max_new: int
    submit_s: float
    prepadded: bool = False
    base_len: int = -1          # resumes only
    requested_new: int = 0
    truncated: bool = False
    n_preempted: int = 0
    first_token_s: float = -1.0


@dataclasses.dataclass
class ContinuousResult:
    """One finished sequence from the continuous engine."""
    request_id: int
    tokens: np.ndarray          # (n_emitted,)
    submit_s: float             # perf_counter timestamps (engine clock)
    admit_s: float
    finish_s: float
    n_iters: int                # decode iterations this sequence was live
    #: fewer tokens than requested were emitted (submit-time cache-room
    #: clamp, or the capacity clip at cache_len)
    truncated: bool = False
    #: times this sequence was preempted and recomputed
    n_preempted: int = 0
    #: engine-clock time the first token landed (the original first
    #: token across preemption; -1 if none landed)
    first_token_s: float = -1.0
    #: cancelled (client disconnect or explicit cancel): ``tokens`` holds
    #: the partial completion emitted before the cancel
    cancelled: bool = False

    @property
    def queue_wait_s(self) -> float:
        return self.admit_s - self.submit_s

    @property
    def ttft_s(self) -> float:
        """Submit -> first token on the engine clock (-1 if no token)."""
        return self.first_token_s - self.submit_s \
            if self.first_token_s >= 0 else -1.0

    @property
    def tpot_s(self) -> float:
        """Mean seconds per token after the first (-1 below 2 tokens)."""
        if self.first_token_s < 0 or len(self.tokens) < 2:
            return -1.0
        return (self.finish_s - self.first_token_s) \
            / (len(self.tokens) - 1)


class ContinuousBatchingEngine:
    """Iteration-level batching backend.

    Every ``step()`` admits queued prompts into free slots, advances
    their chunked prefills under the per-iteration token budget, then
    runs ONE decode iteration over all ``n_slots`` rows.

    ``kv_layout="paged"``: each chunk attends the block pool through the
    slot's block table (``paged_prefill_attention``) and decode reads it
    the same way (``paged_decode_attention`` or its split-K form). A slot
    only holds the blocks its sequence needs (prompt bucket + requested
    decode tokens); admission is gated on reservable blocks, blocks are
    allocated when decode crosses a block boundary, and eviction returns
    them.

    ``kv_layout="dense"`` (the default, as in the reference): one
    ``(n_slots, cache_len)`` cache row per slot (a ``window``-slot ring
    for windowed layers, a state row for recurrent ones). Chunks prefill into a one-slot staging cache that is grafted
    into the slot's row when the prompt is done; decode runs
    ``decode_attention`` over the rows.

    The engine runs on ``device`` (default ``"cuda"``, which raises
    without a GPU; pass ``device="cpu"`` for the plain versions). Weights
    are drawn from ``seed`` unless ``params`` (the port's layout) are
    given or :meth:`load_jax_params` carries the reference's across.
    ``share_from`` (an engine of the same config on the same device)
    shares that engine's model and params dict instead, as the pool's
    instances of one model do; the KV cache, block table and slots stay
    this engine's own. Everything is float32.
    """

    def __init__(self, cfg: ModelConfig, max_slots: int = 4,
                 max_seq: int = 256, seed: int = 0,
                 kv_layout: str = "dense", block_size: int = 16,
                 kv_blocks: Optional[int] = None, kv_host_blocks: int = 0,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False, spec_k: int = 0,
                 mesh=None, device="cuda",
                 params: Optional[Dict] = None,
                 share_from: Optional["ContinuousBatchingEngine"] = None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        for flag, what in ((prefix_cache, "prefix_cache"),
                           (spec_k > 0, "spec_k > 0"),
                           (kv_host_blocks > 0, "kv_host_blocks > 0"),
                           (mesh is not None, "mesh (tensor parallelism)")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP.md, Queue A items "
                    "5 and 10)")
        if kv_layout == "paged":
            check_paged_supported(cfg)
        else:
            check_supported(cfg)
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = max(1, max_slots)
        self.cache_len = max_seq
        self.kv_layout = kv_layout
        #: per-iteration cap on prefill-chunk + resident-decode tokens
        #: (None = uncapped). Mutable between steps.
        self.token_budget = token_budget
        if share_from is not None and share_from.cfg == cfg:
            if share_from.device != self.device:
                raise ValueError(
                    f"share_from donor lives on {share_from.device}, this "
                    f"engine on {self.device}")
            # co-resident instances of one model share weights (the
            # reference's share_from, engine.py:909); the KV cache below
            # stays per-instance
            self.model = share_from.model
            self.params = share_from.params
        else:
            self.model = build_model(cfg)
            self.params = self.model.init(seed, device=self.device) \
                if params is None else to_device(params, self.device)
        if kv_layout == "paged":
            self.block_size = block_size
            self.blocks_per_slot = -(-self.cache_len // block_size)
            if kv_blocks is None:
                # dense-equivalent worst case: admission can never refuse
                # a request the dense layout would have taken
                kv_blocks = self.n_slots * self.blocks_per_slot
            self.allocator = BlockAllocator(kv_blocks, block_size)
            # pool includes the null block 0 (id range 0..kv_blocks)
            self.cache = self.model.init_paged_cache(
                self.n_slots, self.cache_len, kv_blocks + 1, block_size,
                device=self.device)
            self.block_tables = np.zeros(
                (self.n_slots, self.blocks_per_slot), np.int32)
        else:
            self.block_size = 0
            self.allocator = None
            self.block_tables = None
            self.cache = self.model.init_cache(self.n_slots, self.cache_len,
                                               device=self.device)
        self.pos = np.zeros((self.n_slots,), np.int32)
        self.pending_tok = np.zeros((self.n_slots,), np.int32)
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.waiting: List[_WaitingReq] = []
        self.n_iters = 0
        self.n_prefill_chunks = 0
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_preempted = 0
        self.n_cancelled = 0
        self.n_prefill_chunk_tokens = 0
        self.prefill_shapes: Set[Tuple[int, int]] = set()
        #: lifecycle hooks, fired synchronously inside engine calls (keep
        #: them cheap; they must not reenter the engine):
        #: ``on_token(request_id, token, index)`` per emitted token, index
        #: its position in the completion, stable across preemption
        #: (re-prefilled context tokens never refire);
        #: ``on_state(request_id, state)``
        #: with "prefill" at slot assignment and "decode" when the prompt
        #: is done
        self.on_token: Optional[Callable] = None
        self.on_state: Optional[Callable] = None
        #: tokens the last step() processed (prefill chunks + resident
        #: decode) and whether it built or loaded a kernel library (the
        #: first use of a kernel); the pool's calibration skips such steps
        self.last_step_tokens = 0
        self.last_step_compiled = False
        self._next_id = 0
        self._t0 = time.perf_counter()

    def load_jax_params(self, params_np: Dict) -> None:
        """Replace the weights with the reference's (its param pytree with
        numpy leaves; see ``repro_torch.models.bridge``). Engines that
        share this one's params dict see the new weights too."""
        new = to_device(params_from_jax(params_np, self.cfg), self.device)
        self.params.clear()
        self.params.update(new)

    # ---- bookkeeping -----------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _note_token(self, s: _Slot) -> None:
        """Stamp ``first_token_s`` and fire ``on_token`` for the token just
        appended to ``s.tokens``. The index is the global completion
        position: tokens emitted before a preemption live in the
        re-prefilled context (``seq_tokens[base_len:]``) and offset the
        resumed ones, so a streaming consumer sees every position once."""
        if s.first_token_s < 0:
            s.first_token_s = self._now()
        if self.on_token is not None:
            prior = len(s.seq_tokens) - s.base_len \
                if s.seq_tokens is not None else 0
            self.on_token(s.request_id, int(s.tokens[-1]),
                          prior + len(s.tokens) - 1)

    def request_blocks(self, prompt_len: int, max_new: int) -> int:
        """Worst-case blocks a request of this shape reserves at admission
        (paged layout): its prompt bucket plus the decode tokens that fit
        the cache."""
        S = _bucket(prompt_len, buckets=SEQ_BUCKETS)
        return self.allocator.blocks_for(
            S + min(max_new, self.cache_len - S))

    def resume_blocks(self, req: PreemptedRequest) -> int:
        """Worst-case blocks a preempted sequence reserves on resume: its
        already-padded context plus the tokens still to emit (a swap
        snapshot's: its frontier plus the tokens still to emit)."""
        if req.swapped:
            return self.allocator.blocks_for(req.pos + req.max_new)
        return self.allocator.blocks_for(len(req.seq_tokens) + req.max_new)

    def admissible(self, prompt_len: int, max_new: int,
                   pending_blocks: int = 0,
                   resume: Optional[PreemptedRequest] = None) -> bool:
        """Could a request of this shape be admitted right now? Dense: a
        free slot. Paged: a free slot and enough unreserved blocks, less
        ``pending_blocks`` a caller has promised to requests it routed
        here but the engine has not reserved yet. With ``resume`` the
        need is the preempted sequence's padded context instead of the
        fresh prompt's shape."""
        if not self.free_slots:
            return False
        if self.kv_layout != "paged":
            return True
        need = self.resume_blocks(resume) if resume is not None \
            else self.request_blocks(prompt_len, max_new)
        return self.allocator.n_available - pending_blocks >= need

    def kv_block_mapping(self) -> Tuple[int, int]:
        """(logical block mappings, distinct physical blocks) over the
        active slots. Without a prefix cache every block has one owner,
        so the two are equal."""
        mapped = [b for s in self.slots if s.active for b in s.blocks]
        return len(mapped), len(set(mapped))

    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.active]

    @property
    def decoding_slots(self) -> List[int]:
        """Active slots whose prefill has completed (the rows a decode
        iteration advances)."""
        return [i for i, s in enumerate(self.slots)
                if s.active and not s.prefilling]

    @property
    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.prefilling]

    @property
    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens not yet prefilled: the unprocessed remainder of
        in-slot chunked prefills plus the padded length of every waiting
        prompt."""
        backlog = sum(len(s.seq_tokens) - s.prefill_pos
                      for s in self.slots if s.prefilling)
        for w in self.waiting:
            backlog += len(w.prompt) if w.prepadded else \
                _bucket(len(w.prompt), buckets=SEQ_BUCKETS)
        return backlog

    # ---- admission -------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 8) -> int:
        """Queue a prompt; it joins a slot at the next iteration boundary.

        Raises when a token id lies outside ``[0, vocab)`` (checked here,
        on the host, once) or when the prompt can never fit a sequence's
        ``cache_len`` budget. Transient pressure (no free slot or free
        blocks) keeps it queued. A ``max_new_tokens`` past the remaining
        cache room is clamped and the result carries ``truncated=True``."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.size and (prompt.min() < 0
                            or prompt.max() >= self.cfg.vocab_size):
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size}), "
                f"got [{prompt.min()}, {prompt.max()}]")
        S = _bucket(len(prompt), buckets=SEQ_BUCKETS)
        room = self.cache_len - S
        if room < 1:
            raise ValueError(
                f"prompt bucket {S} does not fit cache_len {self.cache_len}")
        if self.kv_layout == "paged":
            need = self.request_blocks(len(prompt), max_new_tokens)
            if need > self.allocator.n_blocks:
                raise ValueError(
                    f"request needs {need} blocks, pool has only "
                    f"{self.allocator.n_blocks}")
        rid = self._next_id
        self._next_id += 1
        granted = min(max_new_tokens, room)
        self.waiting.append(_WaitingReq(
            rid, prompt, granted, self._now(),
            requested_new=max_new_tokens,
            truncated=granted < max_new_tokens))
        return rid

    def submit_resume(self, req: PreemptedRequest) -> int:
        """Re-queue a preempted sequence (possibly from another engine of
        the same model) under a fresh engine request id; the caller
        correlates through its own bookkeeping. The padded context always
        fits ``cache_len``: ``len(seq_tokens) + max_new`` is the footprint
        the sequence was first admitted with. A swapped snapshot is
        refused: its blocks would sit in a host tier, which this port's
        engine does not have."""
        if req.swapped:
            raise ValueError(
                "swap snapshot is pinned to the engine holding its host "
                "blocks; this engine has no host tier (ROADMAP.md, Queue A "
                "item 6)")
        rid = self._next_id
        self._next_id += 1
        self.waiting.append(_WaitingReq(
            rid, np.asarray(req.seq_tokens, np.int32), req.max_new,
            req.submit_s, prepadded=True, base_len=req.base_len,
            requested_new=req.requested_new, truncated=req.truncated,
            n_preempted=req.n_preempted,
            first_token_s=req.first_token_s))
        return rid

    def admit(self) -> int:
        """Move waiting prompts into free slots, FIFO; under the paged
        layout only while the head request's worst-case block count is
        reservable. Admission only ASSIGNS the slot (reserves blocks and
        allocates the prompt's blocks, or makes the dense staging cache;
        builds the left-padded token sequence); the prefill itself
        advances in budget-bounded chunks inside ``step()``. Returns
        #admissions."""
        n = 0
        free = self.free_slots
        while self.waiting and free:
            w = self.waiting[0]
            if w.prepadded:  # a preempted sequence: prompt + emitted
                seq = w.prompt
                base_len = w.base_len
            else:
                S = _bucket(len(w.prompt), buckets=SEQ_BUCKETS)
                seq = np.zeros((S,), np.int32)
                seq[S - len(w.prompt):] = w.prompt
                base_len = S
            reserved = n0 = 0
            ids: List[int] = []
            staging = None
            if self.kv_layout == "paged":
                reserved = self.allocator.blocks_for(len(seq) + w.max_new)
                if not self.allocator.reserve(reserved):
                    break  # FIFO: head of queue blocks on memory
                # allocate the prompt's blocks now; the decode tail of the
                # reservation is claimed lazily at block boundaries in
                # step(). block_tables stays on the null block until the
                # prefill lands (the decode batch's dummy writes for this
                # row keep sinking into the null block); chunks carry
                # their own table row.
                n0 = self.allocator.blocks_for(len(seq))
                ids = [self.allocator.alloc_reserved() for _ in range(n0)]
            else:
                staging = self.model.init_cache(1, self.cache_len,
                                                device=self.device)
            self.waiting.pop(0)
            slot = free.pop(0)
            self.slots[slot] = _Slot(
                request_id=w.request_id, remaining=w.max_new,
                submit_s=w.submit_s, admit_s=self._now(), blocks=ids,
                n_outstanding=reserved - n0, seq_tokens=seq,
                base_len=base_len, staging=staging,
                requested_new=w.requested_new, truncated=w.truncated,
                n_preempted=w.n_preempted, first_token_s=w.first_token_s)
            self.pos[slot] = 0
            self.n_admitted += 1
            n += 1
            if self.on_state is not None:
                self.on_state(w.request_id, "prefill")
        return n

    # ---- chunked prefill (docs/ARCHITECTURE.md §5) -----------------------
    def _int_tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _prefill_step(self, budget_left: int) -> int:
        """Advance in-slot chunked prefills by at most ``budget_left``
        tokens, in power-of-two pieces of at most ``_MAX_CHUNK``. Paged:
        each chunk runs directly against the pool through a table row
        built from the slot's allocated blocks. Dense: each chunk runs
        against the slot's staging cache. A slot whose last chunk lands
        joins the decode batch of this same iteration. Returns tokens
        processed."""
        done_tokens = 0
        for i in list(self.prefilling_slots):
            s = self.slots[i]
            logits = None
            while s.prefilling and budget_left > 0:
                rem = len(s.seq_tokens) - s.prefill_pos
                c = min(rem, budget_left, _MAX_CHUNK)
                c = 1 << (c.bit_length() - 1)  # largest power of two <= c
                toks = s.seq_tokens[s.prefill_pos:s.prefill_pos + c]
                self.prefill_shapes.add((c, self.cache_len))
                batch = {"tokens": self._int_tensor(toks[None, :]),
                         "pos": self._int_tensor([s.prefill_pos])}
                if self.kv_layout == "paged":
                    tbl = np.zeros((1, self.blocks_per_slot), np.int32)
                    tbl[0, :len(s.blocks)] = s.blocks
                    batch["block_tables"] = self._int_tensor(tbl)
                    logits, self.cache = self.model.prefill_chunk(
                        self.params, self.cache, batch)
                else:
                    logits, s.staging = self.model.prefill_chunk(
                        self.params, s.staging, batch)
                self.n_prefill_chunks += 1
                s.prefill_pos += c
                budget_left -= c
                done_tokens += c
            if logits is not None and not s.prefilling:
                self._finish_prefill(i, logits)
        self.n_prefill_chunk_tokens += done_tokens
        return done_tokens

    def _finish_prefill(self, slot: int, logits: torch.Tensor) -> None:
        """Last chunk landed: point the block table at the prompt's blocks
        (paged) or graft the staging cache into the slot's row (dense),
        and hand the slot to the decode loop."""
        s = self.slots[slot]
        if self.kv_layout == "paged":
            self.block_tables[slot, :len(s.blocks)] = s.blocks
        else:
            self._graft(s.staging, slot)
            s.staging = None
        self.pos[slot] = s.prefill_pos
        self.pending_tok[slot] = int(sample_tokens(logits[0, -1, :]))
        if self.on_state is not None:
            self.on_state(s.request_id, "decode")

    def _graft(self, one_cache: List[Dict], slot: int) -> None:
        """Copy a prefilled one-slot dense cache into row ``slot`` of every
        leaf of every layer's cache, in place (the reference's
        ``graft_layer`` maps over every leaf): K/V rows, and a recurrent
        layer's state (``h`` and ``conv``; ``att_state``, ``att_shift``
        and ``ffn_shift``). The staging cache has the slot row's shape
        (``cache_len`` long, rings ``window``), so the whole row is
        replaced: prefill wrote [0, S), the rest is zeros."""
        for full, one in zip(self.cache, one_cache):
            for key, t in full.items():
                t[slot].copy_(one[key][0])

    # ---- preemption ------------------------------------------------------
    def preemption_candidates(self) -> List[Tuple[int, int, int]]:
        """(slot, request_id, freeable blocks) for every preemptible
        resident: decoding slots only, never a mid-chunk prefill (its
        chunks would be thrown away and bought again at once). Every block
        has one owner here (no prefix cache), so all of a slot's blocks
        and the unconsumed rest of its reservation free on eviction."""
        return [(i, s.request_id, s.n_outstanding + len(s.blocks))
                for i, s in enumerate(self.slots)
                if s.active and not s.prefilling]

    def can_swap(self, slot: int) -> bool:
        """Could ``slot`` be preempted with ``mode="swap"``? Never: the
        host KV tier is not ported (ROADMAP.md, Queue A item 6)."""
        return False

    def _emitted(self, s: _Slot) -> List[int]:
        """Every token ``s`` has emitted: those before a preemption live
        in the re-prefilled context, the rest in ``s.tokens``."""
        if s.seq_tokens is not None and s.base_len < len(s.seq_tokens):
            return [int(t) for t in s.seq_tokens[s.base_len:]] + s.tokens
        return s.tokens

    def _free_slot(self, i: int) -> None:
        """Return slot ``i``'s blocks and the unconsumed rest of its
        reservation (paged) and empty the slot."""
        s = self.slots[i]
        if self.kv_layout == "paged":
            self.allocator.free(s.blocks)
            self.allocator.unreserve(s.n_outstanding)
            self.block_tables[i, :] = 0
        self.pos[i] = 0
        self.slots[i] = _Slot()

    def preempt(self, slot: int, requeue: bool = True,
                mode: str = "recompute") -> PreemptedRequest:
        """Evict the decoding sequence in ``slot``, returning its blocks
        and the unconsumed rest of its reservation at once. The snapshot
        resumes by re-prefilling the padded prompt plus every token
        emitted so far, so greedy output is token-identical to an
        uninterrupted run. ``mode="swap"`` raises, as in the reference
        when ``can_swap`` does not hold: here it never does.
        ``requeue=True`` puts the snapshot back at the head of this
        engine's queue; a pool passes ``requeue=False`` and routes it
        through its own EDF queue (``submit_resume``)."""
        if mode not in ("recompute", "swap"):
            raise ValueError(f"unknown preempt mode {mode!r}")
        s = self.slots[slot]
        if not s.active:
            raise ValueError(f"slot {slot} holds no sequence")
        if s.prefilling:
            raise ValueError("cannot preempt a mid-chunk prefill")
        if mode == "swap":
            raise ValueError(
                f"slot {slot} is not swappable (host tier off, "
                "non-pageable stack, or host pool full)")
        req = PreemptedRequest(
            s.request_id,
            np.concatenate([s.seq_tokens, np.asarray(s.tokens, np.int32)]),
            base_len=s.base_len, max_new=s.remaining, submit_s=s.submit_s,
            requested_new=s.requested_new, truncated=s.truncated,
            n_preempted=s.n_preempted + 1, first_token_s=s.first_token_s)
        self._free_slot(slot)
        self.n_preempted += 1
        if requeue:
            self.waiting.insert(0, _WaitingReq(
                req.request_id, req.seq_tokens, req.max_new, req.submit_s,
                prepadded=True, base_len=req.base_len,
                requested_new=req.requested_new, truncated=req.truncated,
                n_preempted=req.n_preempted,
                first_token_s=req.first_token_s))
        return req

    def release_swap(self, req: PreemptedRequest) -> PreemptedRequest:
        """Convert a swap snapshot back into a recompute snapshot, freeing
        its host blocks: a recompute snapshot is returned as it is, and a
        swapped one is refused, since no engine of the port holds a host
        pool."""
        if not req.swapped:
            return req
        raise ValueError(
            "swap snapshot is pinned to a different engine's host pool")

    # ---- cancellation ----------------------------------------------------
    def cancel(self, request_id: int) -> Optional[ContinuousResult]:
        """Tear ``request_id`` down at whatever phase it is in (queued,
        mid-chunk prefill, decoding, or queued again after a preemption)
        and free its memory before returning: its blocks go back to the
        allocator and the unconsumed rest of its reservation is
        cancelled. Returns a ``ContinuousResult`` with ``cancelled=True``
        carrying the partial completion, or ``None`` when the id is not
        live here (finished already, or resident elsewhere in a pool)."""
        for qi, w in enumerate(self.waiting):
            if w.request_id != request_id:
                continue
            self.waiting.pop(qi)
            # a requeued preemption carries its earlier tokens in the
            # prepadded context; a fresh prompt has none
            emitted = w.prompt[w.base_len:] if w.prepadded \
                else np.zeros((0,), np.int32)
            self.n_cancelled += 1
            return ContinuousResult(
                request_id, np.asarray(emitted, np.int32),
                submit_s=w.submit_s, admit_s=-1.0, finish_s=self._now(),
                n_iters=0, truncated=w.truncated, n_preempted=w.n_preempted,
                first_token_s=w.first_token_s, cancelled=True)
        for i, s in enumerate(self.slots):
            if not (s.active and s.request_id == request_id):
                continue
            emitted = self._emitted(s)
            res = ContinuousResult(
                request_id, np.asarray(emitted, np.int32),
                submit_s=s.submit_s, admit_s=s.admit_s, finish_s=self._now(),
                n_iters=len(emitted), truncated=s.truncated,
                n_preempted=s.n_preempted, first_token_s=s.first_token_s,
                cancelled=True)
            self._free_slot(i)
            self.n_cancelled += 1
            self.n_evicted += 1
            return res
        return None

    # ---- iteration -------------------------------------------------------
    def _release(self, i: int) -> None:
        """Evict slot ``i``. Paged: free-on-evict, blocks return to the
        pool and the unconsumed tail of the reservation is cancelled."""
        self._free_slot(i)
        self.n_evicted += 1

    def step(self) -> List[ContinuousResult]:
        """One engine iteration: admit, advance chunked prefills under the
        per-iteration token budget, then ONE decode iteration over all
        slots; evicts after. The budget caps prefill-chunk plus resident
        decode tokens. Returns the sequences that finished. Inactive
        slots decode a dummy token at position 0 (into the null block, or
        their own row, which admission's graft overwrites), keeping the
        decode shape fixed at (n_slots, 1)."""
        loads = _build.n_loads
        finished = self._step()
        self.last_step_compiled = _build.n_loads != loads
        return finished

    def _step(self) -> List[ContinuousResult]:
        self.admit()
        n_dec = len(self.decoding_slots)
        budget = self.token_budget if self.token_budget is not None \
            else 1 << 62
        self.last_step_tokens = self._prefill_step(max(0, budget - n_dec))
        active = self.decoding_slots
        if not active:
            return []
        self.last_step_tokens += len(active)
        for i in active:
            s = self.slots[i]
            s.tokens.append(int(self.pending_tok[i]))
            s.remaining -= 1
            self._note_token(s)
        batch = {"tokens": self._int_tensor(self.pending_tok[:, None]),
                 "pos": self._int_tensor(self.pos)}
        if self.kv_layout == "paged":
            # alloc-on-decode-boundary: the write at ``pos`` needs its
            # block mapped before the decode runs; the admission
            # reservation guarantees the free list cannot be empty here
            bs = self.block_size
            for i in active:
                s = self.slots[i]
                while self.pos[i] >= len(s.blocks) * bs:
                    bid = self.allocator.alloc_reserved()
                    s.n_outstanding -= 1
                    self.block_tables[i, len(s.blocks)] = bid
                    s.blocks.append(bid)
            batch["block_tables"] = self._int_tensor(self.block_tables)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    batch)
        nxt = sample_tokens(logits[:, -1, :])
        self.n_iters += 1
        finished: List[ContinuousResult] = []
        now = self._now()
        for i in active:
            s = self.slots[i]
            # stay inside the cache: clip sequences at capacity (and
            # record the truncation — the caller asked for more tokens)
            if self.pos[i] + 1 >= self.cache_len and s.remaining > 0:
                s.truncated = True
                s.remaining = 0
            if s.remaining <= 0:
                emitted = self._emitted(s)
                finished.append(ContinuousResult(
                    s.request_id, np.asarray(emitted, np.int32),
                    submit_s=s.submit_s, admit_s=s.admit_s, finish_s=now,
                    n_iters=len(emitted), truncated=s.truncated,
                    n_preempted=s.n_preempted,
                    first_token_s=s.first_token_s))
                self._release(i)
            else:
                self.pending_tok[i] = nxt[i]
                self.pos[i] = self.pos[i] + 1
        return finished

    def run(self, prompts: List[np.ndarray], max_new_tokens: int = 8,
            max_iters: int = 10_000) -> List[ContinuousResult]:
        """Submit ``prompts`` and iterate until every sequence finishes."""
        for p in prompts:
            self.submit(p, max_new_tokens)
        done: List[ContinuousResult] = []
        while (self.waiting or self.active_slots) and max_iters > 0:
            done.extend(self.step())
            max_iters -= 1
        done.sort(key=lambda r: r.request_id)
        return done

    # ---- KV occupancy accounting (docs/ARCHITECTURE.md §5) --------------
    @property
    def kv_used_tokens(self) -> int:
        """Cache positions live sequences occupy (written or about to be
        written next iteration); mid-prefill sequences count the tokens
        their chunks have written so far."""
        return int(sum(int(self.pos[i]) + 1 for i in self.decoding_slots)
                   + sum(self.slots[i].prefill_pos
                         for i in self.prefilling_slots))

    @property
    def kv_allocated_tokens(self) -> int:
        """Cache positions committed: the whole slab (dense), or live
        blocks × block_size (paged)."""
        if self.kv_layout == "paged":
            return self.allocator.n_live * self.block_size
        return self.n_slots * self.cache_len

    @property
    def kv_unique_used_tokens(self) -> int:
        """Physical cache positions live sequences occupy: per block
        under the paged layout (positions past a slot's allocated blocks
        do not count), ``kv_used_tokens`` under the dense one."""
        if self.kv_layout != "paged":
            return self.kv_used_tokens
        bs = self.block_size
        total = 0
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            c = s.prefill_pos if s.prefilling else int(self.pos[i]) + 1
            total += sum(max(0, min(bs, c - idx * bs))
                         for idx in range(len(s.blocks)))
        return total

    def stats(self) -> Dict[str, float]:
        """Counters + KV occupancy metrics (the reference's keys for the
        features the port has, plus ``n_prefill_chunks``)."""
        used = float(self.kv_used_tokens)
        uniq = float(self.kv_unique_used_tokens)
        alloc = float(self.kv_allocated_tokens)
        return {
            "n_iters": float(self.n_iters),
            "n_prefill_chunks": float(self.n_prefill_chunks),
            "n_admitted": float(self.n_admitted),
            "n_evicted": float(self.n_evicted),
            "n_prefill_shapes": float(len(self.prefill_shapes)),
            "n_slots": float(self.n_slots),
            "kv_used_tokens": used,
            "kv_allocated_tokens": alloc,
            "kv_waste_frac": 1.0 - uniq / alloc if alloc else 0.0,
            "kv_reserved_tokens": float(
                self.allocator.n_reserved * self.block_size
                if self.kv_layout == "paged" else 0),
            "queue_depth": float(len(self.waiting)),
            "n_preempted": float(self.n_preempted),
            "n_cancelled": float(self.n_cancelled),
            "prefill_backlog_tokens": float(self.prefill_backlog_tokens),
            "token_budget": float(self.token_budget or 0),
        }
