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
  budget-bounded chunks. ``kv_layout="paged"`` keeps linear attention
  K/V in a shared block pool addressed through each slot's block table
  (docs/ARCHITECTURE.md §5). Where every layer is paged the chunks write
  the pool straight through the table ("fused" prefill); a hybrid stack
  (windowed rings, recurrent states beside the pool) and the dense
  layout chunk into a per-slot staging cache that is grafted into the
  slot (its blocks, and its row of the dense leaves) when the prompt is
  done. ``prefix_cache=True`` (paged, every layer paged) shares full
  prompt blocks between same-prefix sequences at refcount+1.

On the card the attention of every layer runs the hand-written kernels
(``repro_torch.kernels``); on the CPU their plain versions.

Both engines serve the attention, the recurrent (RG-LRU, RWKV-6), the
MoE and the frontend (qwen2-vl) families; a recurrent layer's per-slot
state sits beside the K/V rows of the dense layout and is grafted with
them. A frontend model's prompt carries ``frontend_tokens`` stub
embeddings ahead of its tokens, so the continuous engine admits it by
one-shot prefill (``chunked`` is False: no chunks, no preemption, no
prefix cache, no speculation) and every footprint counts those F
positions. Encoder-decoder models (seamless) run in round mode only: the
continuous engine refuses them, as the reference's does. An MoE layer's
capacity follows the rows of each forward, as in the reference: all
``n_slots`` rows of a decode iteration (idle slots' dummy tokens
included), the unpadded rows of a prefill chunk, and every row of a
round's left-padded ``(B, S)`` batch.

For the instance pool (``serving/runtime.py``) the continuous engine
shares one model and params dict between instances (``share_from``),
reports per-token and phase events (``on_token``, ``on_state``), counts
each step's tokens and whether it loaded a kernel library
(``last_step_tokens``, ``last_step_compiled``), and prices admission
(``request_blocks``, ``admissible``, ``kv_block_mapping``).

Tracing: a continuous engine's ``step()`` run under ``torch.profiler``
records its spans (the step, admission, each upload, each prefill piece,
the decode or verify forward, each readback) on the host's
``time.perf_counter()`` clock, each forward with its device interval on
a card, into ``serving.tracing.RECORDER``; an operator runs the engine
inside a profiler session and reads ``RECORDER.spans(engine)`` beside
the profiler's trace. Without a session a step records nothing.
``stats()`` counts the blocking uploads and readbacks (``n_host_syncs``)
whether or not a session runs.

Preemption (recompute: the snapshot re-prefills the padded prompt plus
every emitted token on resume; swap: its blocks go to a pinned host tier
and come back with no recompute), the prefix cache's host spill,
speculative decoding (n-gram or draft-model proposals checked by one
verify forward per iteration, ``paged_prefill_attention`` on the card)
and cancellation at any phase are ported, and so is seeded sampling,
which draws from its own ``torch.Generator`` and so matches the
reference in distribution, not token for token.

Tensor parallelism: a continuous engine given a ``("model",)`` mesh
(``repro_torch.launch.mesh.make_tp_mesh``) splits its weights and KV cache
by head over the mesh's ranks and runs every step through the rank-split
forward (``repro_torch.models.tp``), one process driving every rank.
Block tables, the allocator, slots and queues stay on the host, one copy
for all ranks. Attention, RG-LRU, RWKV-6 and MoE layers all split (each
rank's recurrent states sit beside its KV pool); frontend and
encoder-decoder engines stay single-device, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.tp import TPModel
from repro_torch.models.transformer import (pad_cache, paged_layer_kind,
                                            scatter_blocks)
from repro_torch.serving import tracing


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


def supports_prefix_cache(cfg: ModelConfig) -> bool:
    """Prefix caching shares physical KV blocks, so every layer's decode
    state must live in the block pool: linear attention KV only
    (``paged_layer_kind``). Recurrent states and windowed rings are
    per-slot dense, and a shared-prefix hit would also need the recurrent
    state at the block boundary, which the cache does not hold; frontend
    and encoder-decoder models bypass the chunked path entirely."""
    if cfg.frontend is not None or cfg.enc_dec:
        return False
    return all(paged_layer_kind(cfg, k) for k in cfg.layer_kinds())


def supports_speculation(cfg: ModelConfig) -> bool:
    """Speculative decoding needs every layer's decode state rewindable:
    rejected linear-attention K/V rows are masked by ``pos`` (dense) or
    freed back to the allocator at block granularity (paged), but a
    recurrent state advances irreversibly per token and a windowed ring
    aliases rejected writes over live positions. That is the prefix
    cache's layer gate, so the two coincide (frontend and
    encoder-decoder models also lack the chunked forward verification
    runs on)."""
    return supports_prefix_cache(cfg)


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
    A frontend model's batch adds zero ``frontend_embeds`` (B, F, d), F =
    ``frontend_tokens``; an encoder-decoder model's adds zero frame
    embeddings (B, max(8, S // 4), d) for its encoder. Returns (the batch,
    S, prompt lengths (B,))."""
    B = _bucket(len(prompts))
    S = _bucket(max(len(p) for p in prompts), buckets=SEQ_BUCKETS)
    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p  # left-pad (last position = last token)
        lens[i] = len(p)
    batch = {"tokens": toks}
    if cfg.frontend is not None and not cfg.enc_dec:
        batch["frontend_embeds"] = np.zeros(
            (B, cfg.frontend_tokens, cfg.d_model), np.float32)
    if cfg.enc_dec:
        batch["frontend_embeds"] = np.zeros(
            (B, max(8, S // 4), cfg.d_model), np.float32)
    return batch, S, lens


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
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        logits, cache = self.model.prefill(self.params, batch)
        if self.device.type == "cuda":  # time the prefill, not its enqueue
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        cache = pad_cache(self.cfg, cache, max_new_tokens)
        # decode starts past the frontend span a frontend model prepends
        F = batch["frontend_embeds"].shape[1] if (
            self.cfg.frontend is not None and not self.cfg.enc_dec) else 0
        pos = torch.full((B,), F + S, dtype=torch.int32, device=self.device)
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
# speculative proposers
# =====================================================================
class NGramProposer:
    """Self-speculative (prompt-lookup) drafting: find the most recent
    earlier occurrence of the context's trailing n-gram and propose the
    tokens that followed it, falling back to shorter n-grams and finally
    to repeating the last token. Host-side lookup, no model forward; the
    verify forward makes proposal quality a throughput knob, never a
    correctness one."""

    def __init__(self, n: int = 2):
        self.n = max(1, n)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """``context`` (1-D int32: prompt, emitted and pending tokens) ->
        (k,) draft tokens continuing it."""
        ctx = np.asarray(context, np.int32)
        L = len(ctx)
        cont = None
        for n in range(min(self.n, L - 1), 0, -1):
            tail = ctx[L - n:]
            for i in range(L - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], tail):
                    cont = ctx[i + n:i + n + k]
                    break
            if cont is not None and len(cont):
                break
        if cont is None or len(cont) == 0:
            cont = ctx[L - 1:] if L else np.zeros(1, np.int32)
        reps = -(-k // len(cont))
        return np.tile(cont, reps)[:k].astype(np.int32)


class DraftModelProposer:
    """Draft-model proposal: a small model greedily decodes ``k`` tokens
    from the tail of the context (at most ``context_window`` tokens),
    re-prefilled per call through round mode. Stateless, so it stays
    right under preemption, prefix sharing and rollback; verification
    keeps the output identical whatever it proposes.

    The draft runs on ``device`` (default ``"cuda"``) with ``params``
    (the port's layout) or weights drawn from ``seed``; torch's generator
    cannot reproduce the reference's JAX-seeded draft, so callers that
    need the reference's draft bridge its weights
    (``repro_torch.models.bridge``)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 context_window: int = 256, device="cuda",
                 params: Optional[Dict] = None):
        self.engine = InferenceEngine(cfg, max_seq=1024, seed=seed,
                                      device=device, params=params)
        self.context_window = context_window

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32)[-self.context_window:]
        if len(ctx) == 0:
            return np.zeros(k, np.int32)
        res = self.engine.generate([ctx], max_new_tokens=k)
        return res.tokens[0].astype(np.int32)


# =====================================================================
# continuous (iteration-level) batching
# =====================================================================
class BlockAllocator:
    """Reference-counted free-list allocator over a paged KV block pool,
    with a hash-keyed cache of full immutable prefix blocks and an
    optional host tier: the port of the reference's ``BlockAllocator``,
    its free-list and LRU order kept bit for bit.

    ``n_blocks`` usable blocks of ``block_size`` tokens; physical ids are
    1..n_blocks (id 0 is the null block inactive batch rows write into,
    never handed out). Admission *reserves* a sequence's worst-case block
    count up front, so the lazy per-decode-boundary ``alloc_reserved``
    can never fail mid-sequence; eviction drops one reference per block
    and cancels the unfilled remainder of the reservation.

    Prefix cache: the engine ``register``s a full, immutable prompt block
    under its token-chain key; ``acquire`` maps that block into another
    sequence at refcount+1. A block whose refcount reaches zero returns
    to the free list when it is unregistered, or parks in an LRU pool
    when it is cached; parked blocks are reclaimed (oldest first, their
    key invalidated) when an allocation finds the free list empty.

    Host tier (``host_blocks > 0``): a second id space 1..host_blocks of
    host-memory blocks. *Swapped* blocks (``_host_live``) hold a
    preempted sequence's KV and belong to its snapshot until resume or
    cancel; *spilled* blocks (``_host_lru`` / ``_host_cache``) hold
    refcount-0 prefix blocks that a device-LRU reclaim demoted instead of
    invalidating, revived by a later ``acquire`` and reclaimable, oldest
    first, when the host tier fills. The allocator is bookkeeping only:
    the engine's ``spill_fn(device_id, host_id)`` and
    ``unspill_fn(host_id, device_id)`` move the bytes.

    Invariants (checked after every step in
    tests/test_torch_engine_fuzz.py):
      * ``n_free + n_cached + n_live == n_blocks`` (disjoint id sets);
      * ``n_available = n_free + n_cached - n_reserved >= 0``;
      * a block mapped by k sequences has refcount k;
      * the null block 0 is never allocated;
      * LRU reclaim only takes refcount-0 blocks;
      * ``n_host_free + n_host_cached + n_host_live == n_host_blocks``.
    ``free`` and ``host_free`` raise on an out-of-range id, a duplicate
    within one call or a double free: any of them would hand one block
    to two owners.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 host_blocks: int = 0):
        if n_blocks < 1:
            raise ValueError("need at least one usable block")
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks, 0, -1))  # pop() -> low ids first
        self._outstanding: Set[int] = set()
        self._refcount: Dict[int, int] = {}
        #: prefix cache: chain key -> block id, the reverse map, and the
        #: LRU pool of refcount-0 cached (reclaimable) blocks
        self._cache: Dict[str, int] = {}
        self._block_key: Dict[int, str] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.n_reserved = 0
        self.n_reclaimed = 0    # cached blocks evicted under pressure
        # ---- host tier ----
        self.n_host_blocks = host_blocks
        self._host_free = list(range(host_blocks, 0, -1))
        self._host_live: Set[int] = set()         # swapped sequence KV
        self._host_cache: Dict[str, int] = {}     # spilled prefix blocks
        self._host_key: Dict[int, str] = {}
        self._host_lru: "OrderedDict[int, None]" = OrderedDict()
        #: the engine's byte movers; None leaves the host tier inert (a
        #: device-LRU reclaim then invalidates its key)
        self.spill_fn: Optional[Callable[[int, int], None]] = None
        self.unspill_fn: Optional[Callable[[int, int], None]] = None
        self.n_spilled = 0      # device LRU entries demoted to host
        self.n_unspilled = 0    # host entries revived to device
        self.n_host_reclaimed = 0  # spilled entries evicted under pressure
        self.n_swapped_out = 0  # sequence blocks swapped device -> host
        self.n_swapped_in = 0   # sequence blocks swapped host -> device

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Refcount-0 blocks parked in the prefix cache's LRU pool:
        reclaimable, so they count toward ``n_available``."""
        return len(self._lru)

    @property
    def n_live(self) -> int:
        """Distinct physical blocks with refcount >= 1 (a shared block
        counts once)."""
        return len(self._outstanding)

    @property
    def n_available(self) -> int:
        """Blocks neither live nor promised to an admitted slot (parked
        LRU blocks are reclaimable, so they count)."""
        return len(self._free) + len(self._lru) - self.n_reserved

    # ---- host tier -------------------------------------------------------
    @property
    def n_host_free(self) -> int:
        return len(self._host_free)

    @property
    def n_host_cached(self) -> int:
        """Spilled prefix blocks parked in the host LRU: reclaimable."""
        return len(self._host_lru)

    @property
    def n_host_live(self) -> int:
        """Host blocks owned by swapped (preempted) sequences, held until
        their snapshot resumes or is cancelled."""
        return len(self._host_live)

    @property
    def n_host_available(self) -> int:
        """Host blocks a swap-out could claim now: free plus reclaimable
        spilled entries (swapped blocks are never reclaimed under their
        owner)."""
        return len(self._host_free) + len(self._host_lru)

    def _host_alloc(self) -> Optional[int]:
        """One host block: the free list first, then the oldest spilled
        entry (its key invalidated). None when every host block holds a
        swapped sequence."""
        if self._host_free:
            return self._host_free.pop()
        if self._host_lru:
            hid, _ = self._host_lru.popitem(last=False)
            del self._host_cache[self._host_key.pop(hid)]
            self.n_host_reclaimed += 1
            return hid
        return None

    def swap_out_alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` host blocks for a preempted sequence's KV, all or
        nothing: None when fewer than ``n`` are available."""
        if self.n_host_available < n:
            return None
        ids = []
        for _ in range(n):
            hid = self._host_alloc()
            assert hid is not None
            self._host_live.add(hid)
            ids.append(hid)
        self.n_swapped_out += n
        return ids

    def host_free(self, ids: List[int]) -> None:
        """Release a swap snapshot's host blocks (its resume landed, or it
        was cancelled), with ``free``'s double-free checks."""
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host block ids in host_free: {ids}")
        for i in ids:
            if i not in self._host_live:
                raise ValueError(
                    f"host_free of block {i}: not currently swapped out")
        for i in ids:
            self._host_live.discard(i)
            self._host_free.append(i)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.block_size)

    def refcount(self, bid: int) -> int:
        return self._refcount.get(bid, 0)

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

    def _reclaim_lru(self) -> int:
        """Evict the least recently parked cached block. With the host
        tier attached (``spill_fn`` set) its key moves to a host block
        instead of being invalidated, one eviction chain over both tiers;
        without one, or with every host block swap-held, the key is
        invalidated. The id serves as a fresh free block."""
        bid, _ = self._lru.popitem(last=False)
        key = self._block_key.pop(bid)
        del self._cache[key]
        self.n_reclaimed += 1
        if self.spill_fn is not None:
            hid = self._host_alloc()
            if hid is not None:
                self.spill_fn(bid, hid)
                self._host_cache[key] = hid
                self._host_key[hid] = key
                self._host_lru[hid] = None
                self.n_spilled += 1
        return bid

    def alloc_reserved(self) -> int:
        """Convert one previously reserved block into a physical id,
        reclaiming from the LRU pool when the free list is empty (never a
        block with live references: the pool holds refcount-0 blocks
        only)."""
        assert self.n_reserved > 0, "alloc without reservation"
        self.n_reserved -= 1
        bid = self._free.pop() if self._free else self._reclaim_lru()
        self._outstanding.add(bid)
        self._refcount[bid] = 1
        return bid

    def free(self, ids: List[int]) -> None:
        """Drop one reference per id. A block reaching refcount 0 returns
        to the free list, or parks in the LRU pool when it is registered
        in the prefix cache, so a later same-prefix admission can revive
        it."""
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
            self._refcount[i] -= 1
            if self._refcount[i] > 0:
                continue  # still referenced by another sequence
            del self._refcount[i]
            self._outstanding.discard(i)
            if i in self._block_key:
                self._lru[i] = None  # evicted but cached (reclaimable)
            else:
                self._free.append(i)

    # ---- prefix cache ----------------------------------------------------
    def cached(self, key: str) -> bool:
        """True when either tier holds ``key`` (a spilled entry is a hit:
        ``acquire`` revives it)."""
        return key in self._cache or key in self._host_cache

    def cached_live(self, key: str) -> bool:
        """True when ``key``'s block is mapped by a live sequence: sharing
        it costs no extra capacity."""
        bid = self._cache.get(key)
        return bid is not None and bid in self._outstanding

    def register(self, key: str, bid: int) -> None:
        """Publish a full immutable block under its chain key. The block
        must be live (its writer still owns it); the first writer wins on
        a key collision, and a block carries at most one key. A live
        device copy supersedes a spilled one, whose host block frees."""
        assert bid in self._outstanding, f"register of non-live block {bid}"
        if key in self._cache or bid in self._block_key:
            return
        if key in self._host_cache:
            hid = self._host_cache.pop(key)
            del self._host_key[hid]
            self._host_lru.pop(hid, None)
            self._host_free.append(hid)
        self._cache[key] = bid
        self._block_key[bid] = key

    def acquire(self, key: str) -> Optional[int]:
        """Map the cached block for ``key`` into another sequence:
        refcount+1 for a live block (costs nothing), revival for a parked
        one (consumes one available block, so it is refused when every
        remaining block is promised to a reservation). A spilled key is
        revived into a fresh device block (free list, else a device-LRU
        reclaim) whose bytes ``unspill_fn`` copies back, under the same
        refusal. Returns the block id, or None on a miss or a refused
        revival."""
        bid = self._cache.get(key)
        if bid is not None:
            if bid in self._outstanding:
                self._refcount[bid] += 1
                return bid
            if self.n_available < 1:
                return None
            del self._lru[bid]
            self._outstanding.add(bid)
            self._refcount[bid] = 1
            return bid
        hid = self._host_cache.get(key)
        if hid is None or self.unspill_fn is None:
            return None
        if self.n_available < 1:
            return None
        # detach the host entry first: claiming the device block can
        # itself reclaim and spill, and must not evict this entry
        del self._host_cache[key]
        del self._host_key[hid]
        del self._host_lru[hid]
        bid = self._free.pop() if self._free else self._reclaim_lru()
        self.unspill_fn(hid, bid)
        self._host_free.append(hid)
        self._outstanding.add(bid)
        self._refcount[bid] = 1
        self._cache[key] = bid
        self._block_key[bid] = key
        self.n_unspilled += 1
        return bid


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
    #: leading blocks of ``blocks`` mapped from the prefix cache at
    #: refcount+1: immutable, so graft and decode write past them
    n_shared: int = 0
    # chunked prefill state machine
    seq_tokens: Optional[np.ndarray] = None  # padded prompt (+ resume ctx)
    base_len: int = 0           # padded-prompt length at first admission
    prefill_pos: int = 0        # tokens of seq_tokens processed so far
    #: unfused layouts (dense, hybrid paged): the one-slot cache the
    #: chunks prefill into
    staging: Optional[List[Dict]] = None
    requested_new: int = 0      # caller-requested max_new (pre-clamp)
    truncated: bool = False
    n_preempted: int = 0
    #: engine-clock time the first token landed, carried across
    #: preemption so TTFT reflects the original first token (-1 before
    #: any token)
    first_token_s: float = -1.0
    #: speculative drafts proposed and accepted since (re-)admission; the
    #: engine's own counters stay monotonic
    n_spec_proposed: int = 0
    n_spec_accepted: int = 0
    #: the bucket padding ahead of the prompt in ``seq_tokens``
    pad: int = 0

    @property
    def active(self) -> bool:
        return self.request_id >= 0

    @property
    def prefilling(self) -> bool:
        return self.active and self.seq_tokens is not None \
            and self.prefill_pos < len(self.seq_tokens)


@dataclasses.dataclass
class PreemptedRequest:
    """Resumable snapshot of a preempted sequence, of two kinds:

    * recompute (``host_blocks is None``): ``seq_tokens`` holds the
      padded prompt plus every token emitted so far, re-prefilled in
      chunks on resume, so greedy output is token-identical to an
      uninterrupted run;
    * swap (``preempt(mode="swap")``): the sequence's KV blocks were
      copied to the engine's host tier. ``seq_tokens`` stays the padded
      prompt; the emitted tokens, the decode position and the pending
      token ride along, so resume maps the blocks back onto fresh device
      ids and decodes on with no recompute. The snapshot owns its host
      blocks until resume or cancel and is pinned to the engine whose
      host pool holds them (``host_engine_id``); ``release_swap`` turns
      it into a recompute snapshot when that engine goes away."""
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
    #: the bucket padding ahead of the prompt in ``seq_tokens``
    pad: int = 0

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
        first_token_s=req.first_token_s, pad=req.pad)


@dataclasses.dataclass
class _WaitingReq:
    """One queued admission: a fresh prompt, (``prepadded``) a preempted
    sequence whose bucket padding is already baked in, or (``swap``) a
    swap snapshot whose KV waits in the host tier, admitted straight to
    decode with no prefill."""
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
    swap: Optional[PreemptedRequest] = None
    pad: int = 0                # resumes only: the prompt's bucket padding


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
    #: speculative drafts proposed and accepted while this sequence was
    #: resident (since its last re-admission, if it was preempted)
    n_spec_proposed: int = 0
    n_spec_accepted: int = 0
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

    ``kv_layout="paged"``: linear attention layers keep K/V in a block
    pool that decode reads through the slot's block table
    (``paged_decode_attention`` or its split-K form). A slot only holds
    the blocks its sequence needs (prompt bucket + requested decode
    tokens); admission is gated on reservable blocks, blocks are
    allocated when decode crosses a block boundary, and eviction returns
    them. Where every layer is paged, each chunk attends the pool through
    a table row (``paged_prefill_attention``); a hybrid stack's windowed
    rings and recurrent states stay per-slot dense beside the pool, and
    its chunks prefill a one-slot staging cache grafted into the slot's
    blocks and rows when the prompt is done. ``prefill_mode`` is the
    reference's: ``"auto"`` takes the pool path wherever it can run,
    ``"fused"`` demands it (``ValueError`` where the layout is not paged
    or a layer is not), and any other value raises ``ValueError``.

    ``prefix_cache=True`` (paged, and every layer paged, else
    ``ValueError`` as in the reference): full prompt blocks are published
    under a chain key over the model name and the padded tokens; a later
    admission maps the longest cached prefix at refcount+1, reserves only
    the rest and prefills from the first uncached token. A chain that
    covers the whole padded prompt copies its tail block into the slot's
    own (copy-on-write), so the last token is re-scored without writing a
    shared block.

    ``kv_layout="dense"`` (the default, as in the reference): one
    ``(n_slots, cache_len)`` cache row per slot (a ``window``-slot ring
    for windowed layers, a state row for recurrent ones). Chunks prefill into a one-slot staging cache that is grafted
    into the slot's row when the prompt is done; decode runs
    ``decode_attention`` over the rows.

    ``spec_k > 0`` (a stack whose every layer can rewind, else
    ``ValueError`` as in the reference): each iteration drafts up to
    ``spec_k`` tokens per decoding slot (``NGramProposer(spec_ngram)``,
    or ``proposer``), scores the pending token and the drafts in one
    ``(n_slots, 1 + k)`` verify forward (``Model.verify_step``: paged
    layers through ``paged_prefill_attention``), accepts the longest
    draft prefix that equals the verify argmax and rolls the rest back
    (dense rows are masked by ``pos``; paged blocks past the frontier go
    back to the allocator). ``spec_k`` is mutable between steps up to
    ``spec_max``, the depth the engine was built for; the dense cache
    carries ``spec_max`` rows of margin past ``cache_len``.

    ``kv_host_blocks > 0`` (paged only): a host tier of pinned CPU
    memory, ``kv_host_blocks`` blocks of every paged layer's K and V.
    Where every layer is paged (``swap_ok``) a decoding sequence can be
    preempted with ``mode="swap"`` (its blocks copied out, copied back on
    resume, no recompute), and the prefix cache spills reclaimed blocks
    there before it would invalidate them.

    ``mesh`` (a ``("model",)`` mesh, ``launch.mesh.make_tp_mesh``):
    tensor parallelism, as the reference's. The weights and the decode
    cache are split over the mesh's ranks (``launch.sharding``'s engine
    rules and ``models.tp``'s cuts: attention and RWKV-6 by head, RG-LRU
    by width, experts over E), ``params`` and ``cache`` become lists in
    rank order, and every step runs the ranks in lockstep through
    ``models.tp.TPModel``; block tables, the allocator, slots and queues
    stay on the host, shared by all ranks, and every direct cache write (a
    copy-on-write block, a graft of KV rows and recurrent states) acts on
    each rank. ``params`` may then also be the shards already cut
    (``TPModel.shard_params``, one tree per rank on its device), which the
    engine takes as they are: a caller can cut with ``consume=True`` and
    hand a model too large for two copies over. The checks are the
    reference's (a ``'model'`` axis, the chunked path, the degree dividing
    the heads, a ``share_from`` donor on the same mesh, no host tier).

    The engine runs on ``device`` (default ``"cuda"``, which raises
    without a GPU; pass ``device="cpu"`` for the plain versions; under a
    mesh, the mesh's rank-0 device, of the same type). Weights
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
                 spec_ngram: int = 2, proposer=None,
                 prefill_mode: str = "auto", mesh=None, device="cuda",
                 params: Optional[Dict] = None,
                 share_from: Optional["ContinuousBatchingEngine"] = None):
        if cfg.enc_dec:
            # cross-attention attends every encoder row unmasked, so a
            # shorter prefilled ck/cv grafted into the slot would attend
            # zero-padded rows (the reference's refusal and message)
            raise NotImplementedError(
                "continuous batching does not support encoder-decoder "
                "architectures yet; use InferenceEngine")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if prefix_cache:
            if kv_layout != "paged":
                raise ValueError(
                    "prefix_cache needs kv_layout='paged' (sharing is "
                    "block-granular)")
            if not supports_prefix_cache(cfg):
                raise ValueError(
                    f"{cfg.name}: prefix_cache needs every layer's decode "
                    "state in the block pool (linear attention only); "
                    "recurrent/windowed/frontend layers keep per-slot "
                    "dense state the cache cannot share")
        self.prefix_cache = prefix_cache
        #: chunked prefill needs plain token prompts: a frontend model is
        #: admitted by one-shot prefill (``_admit_inline``) and so cannot
        #: be preempted or resumed
        self.chunked = cfg.frontend is None
        # the reference's gate and messages: chunks run straight against
        # the pool where every layer is paged; dense and hybrid layouts go
        # through a staging cache
        if prefill_mode not in ("auto", "fused"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        fused_ok = (kv_layout == "paged" and self.chunked
                    and supports_prefix_cache(cfg))
        if prefill_mode == "fused" and not fused_ok:
            raise ValueError(
                "prefill_mode='fused' needs kv_layout='paged', the "
                "chunked-prefill path, and every layer's decode state "
                "in the block pool")
        self.fused_prefill = fused_ok
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k > 0 and not supports_speculation(cfg):
            raise ValueError(
                f"{cfg.name}: speculative decoding needs every layer's "
                "decode state rewindable (linear attention only); "
                "recurrent states advance irreversibly and windowed ring "
                "buffers alias rejected writes over live positions")
        #: the deepest speculation this engine was built for (the dense
        #: margin and the verify table's null columns depend on it);
        #: ``spec_k`` is the current depth, mutable between steps and
        #: clamped to ``spec_max`` at use
        self.spec_max = spec_k
        self.spec_k = spec_k
        self.proposer = proposer if proposer is not None \
            else NGramProposer(spec_ngram)
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        self.n_spec_steps = 0
        if kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {kv_host_blocks}")
        if kv_host_blocks > 0 and kv_layout != "paged":
            raise ValueError(
                "kv_host_blocks needs kv_layout='paged' (the host tier "
                "swaps block-granular KV)")
        #: tensor parallelism: the ``("model",)`` mesh this instance
        #: spans (None: one device). Weights and the KV cache, dense slabs
        #: and block pools alike, are split by head over its ranks;
        #: ``self.params`` and ``self.cache`` are then lists in rank order
        #: and ``self.model`` the rank-split forward. The reference's
        #: checks, in its order (``TPModel`` holds the mesh's and the
        #: config's).
        self.mesh = mesh
        tp_model = None
        if mesh is not None:
            tp_model = TPModel(cfg, mesh)
            if kv_host_blocks > 0:
                raise ValueError(
                    "the host KV tier is single-device for now: swap-in "
                    "writes outside the step would drop the pool's "
                    "sharding")
            if resolve_device(device).type != mesh.devices[0].type:
                raise ValueError(
                    f"engine device {device!r} is not the mesh's "
                    f"({mesh.devices[0]})")
        self.kv_host_blocks = kv_host_blocks
        #: swapping a sequence or spilling a prefix block moves only
        #: block-pool state, so every layer must be paged (the prefix
        #: cache's gate); a hybrid stack keeps recompute on resume
        self.swap_ok = kv_host_blocks > 0 and supports_prefix_cache(cfg)
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
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
            if share_from.mesh != mesh:
                raise ValueError(
                    "share_from donor spans a different mesh; instances "
                    "share weights only at the same TP degree")
            # co-resident instances of one model share weights (the
            # reference's share_from, engine.py:909); the KV cache below
            # stays per-instance
            self.model = share_from.model
            self.params = share_from.params
        else:
            self.model = build_model(cfg)
            if isinstance(params, list):  # a mesh's shards, cut already
                if mesh is None or len(params) != tp_model.tp:
                    raise ValueError(
                        f"params as {len(params)} shards need a mesh of "
                        "that degree")
                self.model, self.params = tp_model, params
            else:
                self.params = self.model.init(seed, device=self.device) \
                    if params is None else to_device(params, self.device)
            if mesh is not None and self.model is not tp_model:
                self.model = tp_model
                self.params = self.model.shard_params(self.params,
                                                      consume=True)
        if kv_layout == "paged":
            self.block_size = block_size
            self.blocks_per_slot = -(-self.cache_len // block_size)
            if kv_blocks is None:
                # dense-equivalent worst case: admission can never refuse
                # a request the dense layout would have taken
                kv_blocks = self.n_slots * self.blocks_per_slot
            self.allocator = BlockAllocator(kv_blocks, block_size,
                                            host_blocks=kv_host_blocks)
            # pool includes the null block 0 (id range 0..kv_blocks)
            self.cache = self.model.init_paged_cache(
                self.n_slots, self.cache_len, kv_blocks + 1, block_size,
                device=self.device)
            self.block_tables = np.zeros(
                (self.n_slots, self.blocks_per_slot), np.int32)
            self.host_pool = None
            if self.swap_ok:
                self.host_pool = self._make_host_pool()
                self.allocator.spill_fn = self._spill_block
                self.allocator.unspill_fn = self._unspill_block
        else:
            self.block_size = 0
            self.allocator = None
            self.block_tables = None
            self.host_pool = None
            # a verify forward writes up to spec_max rows past a slot's
            # frontier before acceptance is known, and the dense writes
            # raise on a row past the slab: the slab carries that margin
            # (cache_len stays the logical capacity everywhere)
            self.cache = self.model.init_cache(
                self.n_slots, self.cache_len + self.spec_max,
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
        #: host-tier accounting: swap preempts and resumes, and each
        #: transfer's (bytes, host ms), which the pool's swap-cost fit
        #: reads (``latency_model.fit_swap_cost``)
        self.n_swap_preempts = 0
        self.n_swap_resumes = 0
        self.swap_samples: List[Tuple[int, float]] = []
        #: the side stream of asynchronous swap-ins, and the event of the
        #: last one's copy out of the pinned staging area (CUDA)
        self._swap_stream = None
        self._staged = None
        self.n_prefill_chunk_tokens = 0
        #: prefix-cache accounting (tokens; rate = hit / (hit + chunked))
        self.n_prefix_lookups = 0
        self.n_prefix_hits = 0
        self.n_prefix_hit_tokens = 0
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
        #: blocking host-device transfers: each upload (``_upload``) and
        #: each token readback (``_readback``)
        self.n_host_syncs = 0
        #: the running step's spans while a profiler session runs, else
        #: None; and the anchor of the last traced step's readback
        #: (``serving/tracing.py``)
        self._tr: Optional[tracing.StepTrace] = None
        self._anchor = None
        #: this engine's key on the spans it records
        self.span_key = tracing.engine_key()
        self._next_id = 0
        self._t0 = time.perf_counter()

    def load_jax_params(self, params_np: Dict) -> None:
        """Replace the weights with the reference's (its param pytree with
        numpy leaves; see ``repro_torch.models.bridge``). Engines that
        share this one's params dict see the new weights too."""
        self.load_params(params_from_jax(params_np, self.cfg))

    def load_params(self, params: Dict) -> None:
        """Replace the weights with ``params`` (the port's layout, whole),
        in place, so engines sharing this one's params see them too;
        under a mesh they are split over its ranks first."""
        params = to_device(params, self.device)
        if self.mesh is not None:
            self.params[:] = self.model.shard_params(params)
            return
        self.params.clear()
        self.params.update(params)

    # ---- bookkeeping -----------------------------------------------------
    def _frontend_tokens(self) -> int:
        """F, the positions a frontend model's stub embeddings take ahead
        of every prompt (0 for plain token models)."""
        return self.cfg.frontend_tokens if self.cfg.frontend is not None \
            else 0

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _note_tokens(self, s: _Slot, n_new: int) -> None:
        """Stamp ``first_token_s`` and fire ``on_token`` for the last
        ``n_new`` entries of ``s.tokens``. The index is the global
        completion position: tokens emitted before a preemption live in
        the re-prefilled context (``seq_tokens[base_len:]``) and offset
        the resumed ones, so a streaming consumer sees every position
        once."""
        if s.first_token_s < 0:
            s.first_token_s = self._now()
        if self.on_token is not None:
            prior = len(s.seq_tokens) - s.base_len \
                if s.seq_tokens is not None else 0
            base = prior + len(s.tokens) - n_new
            for j in range(n_new):
                self.on_token(s.request_id,
                              int(s.tokens[len(s.tokens) - n_new + j]),
                              base + j)

    def request_blocks(self, prompt_len: int, max_new: int) -> int:
        """Worst-case blocks a request of this shape reserves at admission
        (paged layout): the frontend span, its prompt bucket and the
        decode tokens that fit the cache."""
        S = self._frontend_tokens() + _bucket(prompt_len, buckets=SEQ_BUCKETS)
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
                   resume: Optional[PreemptedRequest] = None,
                   prompt: Optional[np.ndarray] = None) -> bool:
        """Could a request of this shape be admitted right now? Dense: a
        free slot. Paged: a free slot and enough unreserved blocks, less
        ``pending_blocks`` a caller has promised to requests it routed
        here but the engine has not reserved yet. With ``resume`` the
        need is the preempted sequence's padded context instead of the
        fresh prompt's shape. With the prefix cache on, blocks the cache
        holds LIVE for this sequence (the ``prompt`` tokens, or the
        resumed context) are discounted: sharing them costs no
        capacity."""
        if not self.free_slots:
            return False
        if self.kv_layout != "paged":
            return True
        if resume is not None:
            need = self.resume_blocks(resume)
            # a swap resume maps no shared prefix block (its KV comes back
            # from the host tier whole): the discount is recompute's only
            if self.prefix_cache and not resume.swapped:
                need -= self._live_shared_blocks(resume.seq_tokens)
        else:
            need = self.request_blocks(prompt_len, max_new)
            if self.prefix_cache and prompt is not None:
                need -= self._live_shared_blocks(
                    self._padded_seq(np.asarray(prompt, np.int32)))
        return self.allocator.n_available - pending_blocks >= max(0, need)

    # ---- prefix cache ----------------------------------------------------
    @staticmethod
    @functools.lru_cache(maxsize=4096)
    def _chain_keys_cached(model: str, block_size: int,
                           seq_bytes: bytes) -> Tuple[str, ...]:
        """Memoized: the router hashes one prompt once per candidate
        instance per pass otherwise; keys depend only on (model, block
        size, padded tokens)."""
        seq = np.frombuffer(seq_bytes, np.int32)
        keys: List[str] = []
        h = hashlib.sha1(model.encode())
        for i in range(len(seq) // block_size):
            h.update(seq[i * block_size:(i + 1) * block_size].tobytes())
            keys.append(h.hexdigest())
        return tuple(keys)

    def _chain_keys(self, seq: np.ndarray) -> Tuple[str, ...]:
        """One chain key per FULL block of ``seq``: an incremental sha1
        over the model name and the token ids up to and including that
        block, so a key matches iff the whole padded prefix matches (the
        left-pad rows are attended, so they are content)."""
        return self._chain_keys_cached(
            self.cfg.name, self.block_size,
            np.ascontiguousarray(seq, np.int32).tobytes())

    def _prefix_lookup(self, seq: np.ndarray
                       ) -> Tuple[List[str], int, Optional[str]]:
        """Longest cached block-aligned prefix of ``seq``: (keys of the
        full blocks to map shared, first uncached token position, the
        copy-on-write source key or None). When the chain covers the
        whole sequence the last block is not mapped shared: its final
        token is re-scored (the first decode step needs its logits), so
        the cached block is copied into the slot's private tail block and
        writes only ever land in unshared blocks."""
        keys = self._chain_keys(seq)
        n_hit = 0
        for k in keys:
            if not self.allocator.cached(k):
                break
            n_hit += 1
        bs = self.block_size
        if n_hit and n_hit * bs >= len(seq):
            return list(keys[:n_hit - 1]), len(seq) - 1, keys[n_hit - 1]
        return list(keys[:n_hit]), n_hit * bs, None

    @staticmethod
    def _padded_seq(prompt: np.ndarray) -> np.ndarray:
        S = _bucket(len(prompt), buckets=SEQ_BUCKETS)
        seq = np.zeros((S,), np.int32)
        seq[S - len(prompt):] = prompt
        return seq

    def cached_prefix_tokens(self, prompt: np.ndarray,
                             prepadded: bool = False) -> int:
        """Tokens of ``prompt`` (a resumed context when ``prepadded``) the
        prefix cache holds now: the router's prefix-affinity signal.
        Read-only: nothing is acquired."""
        if not self.prefix_cache:
            return 0
        seq = np.asarray(prompt, np.int32) if prepadded \
            else self._padded_seq(np.asarray(prompt, np.int32))
        return self._prefix_lookup(seq)[1]

    def _live_shared_blocks(self, seq: np.ndarray) -> int:
        """Blocks an admission of the padded sequence ``seq`` would map
        from LIVE cached blocks (refcount >= 1); a parked hit is left out,
        since reviving it consumes an available block anyway."""
        n = 0
        for k in self._chain_keys(np.asarray(seq, np.int32)):
            if not self.allocator.cached_live(k):
                break
            n += 1
        if n and n * self.block_size >= len(seq):
            n -= 1  # the last block stays private (copy-on-write)
        return n

    def _copy_pool_block(self, dst: int, src: int) -> None:
        """Copy one physical block across every paged layer's K and V, in
        place (the copy-on-write of a fully covering chain's tail block;
        every layer is paged wherever the prefix cache is on), on every
        rank."""
        for rank in self._ranks(self.cache):
            for c in rank:
                for key in ("k", "v"):
                    c[key][dst].copy_(c[key][src])

    def _ranks(self, cache) -> List:
        """A cache (the engine's or a staging cache) as a list of per-rank
        caches: itself under a mesh, one rank without."""
        return cache if self.mesh is not None else [cache]

    @property
    def tp_degree(self) -> int:
        """Devices this instance spans (1 = single-device engine)."""
        return int(self.mesh.shape["model"]) if self.mesh is not None else 1

    def kv_block_mapping(self) -> Tuple[int, int]:
        """(logical block mappings, distinct physical blocks) over the
        active slots: the pool sums these across instances."""
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
        in-slot chunked prefills plus the padded length (frontend span
        included) of every waiting prompt."""
        backlog = sum(len(s.seq_tokens) - s.prefill_pos
                      for s in self.slots if s.prefilling)
        for w in self.waiting:
            if w.swap is not None:
                continue  # a swap resume maps its blocks back: no prefill
            backlog += len(w.prompt) if w.prepadded else \
                self._frontend_tokens() + _bucket(len(w.prompt),
                                                  buckets=SEQ_BUCKETS)
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
        F = self._frontend_tokens()
        room = self.cache_len - (F + S)
        if room < 1:
            raise ValueError(
                f"prompt bucket {S} (+{F} frontend) does not fit cache_len "
                f"{self.cache_len}")
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
        the sequence was first admitted with. A swap snapshot resumes only
        on the engine whose host pool holds its blocks (``release_swap``
        it there to resume elsewhere). An engine without the chunked path
        (a frontend model) raises ``NotImplementedError``."""
        if not self.chunked:
            raise NotImplementedError(
                "preemption-resume needs the chunked-prefill path "
                "(plain token prompts)")
        if req.swapped and req.host_engine_id != id(self):
            raise ValueError(
                "swap snapshot is pinned to the engine holding its host "
                "blocks; release_swap() it there to resume elsewhere")
        rid = self._next_id
        self._next_id += 1
        self.waiting.append(_WaitingReq(
            rid, np.asarray(req.seq_tokens, np.int32), req.max_new,
            req.submit_s, prepadded=True, base_len=req.base_len,
            requested_new=req.requested_new, truncated=req.truncated,
            n_preempted=req.n_preempted,
            first_token_s=req.first_token_s,
            swap=req if req.swapped else None, pad=req.pad))
        return rid

    def admit(self) -> int:
        """Move waiting prompts into free slots, FIFO; under the paged
        layout only while the head request's worst-case block count is
        reservable. With the prefix cache on, the longest cached prefix
        is mapped at refcount+1 first and only the rest is reserved (an
        ``acquire`` that would break a reservation ends the chain there).
        A swap resume maps its host blocks back and decodes at once
        (``_admit_swap``). Admission otherwise only ASSIGNS the slot (maps and reserves blocks and
        allocates the prompt's uncached ones, or makes the staging cache;
        builds the left-padded token sequence); the prefill itself
        advances in budget-bounded chunks inside ``step()``. Returns
        #admissions."""
        n = 0
        free = self.free_slots
        while self.waiting and free:
            w = self.waiting[0]
            if w.swap is not None:
                if not self._admit_swap(w, free):
                    break  # FIFO: head of queue blocks on memory
                n += 1
                continue
            if not self.chunked:
                if not self._admit_inline(w, free):
                    break  # FIFO: head of queue blocks on memory
                n += 1
                continue
            if w.prepadded:  # a preempted sequence: prompt + emitted
                seq = w.prompt
                base_len, pad = w.base_len, w.pad
            else:
                seq = self._padded_seq(w.prompt)
                base_len = len(seq)
                pad = base_len - len(w.prompt)
            reserved = n0 = pos0 = 0
            shared: List[int] = []
            cow_key: Optional[str] = None
            if self.kv_layout == "paged":
                need = self.allocator.blocks_for(len(seq) + w.max_new)
                if self.prefix_cache:
                    self.n_prefix_lookups += 1
                    hit_keys, pos0, cow_key = self._prefix_lookup(seq)
                    for k in hit_keys:
                        bid = self.allocator.acquire(k)
                        if bid is None:
                            break
                        shared.append(bid)
                    if len(shared) < len(hit_keys):
                        pos0 = len(shared) * self.block_size
                        cow_key = None
                reserved = need - len(shared)
                if not self.allocator.reserve(reserved):
                    if shared:
                        self.allocator.free(shared)
                    break  # FIFO: head of queue blocks on memory
            self.waiting.pop(0)
            slot = free.pop(0)
            ids = list(shared)
            staging = None
            if self.kv_layout == "paged":
                # allocate the uncached prompt blocks now; the decode tail
                # of the reservation is claimed lazily at block boundaries
                # in step(). block_tables stays on the null block until
                # the prefill lands (the decode batch's dummy writes for
                # this row keep sinking into the null block); chunks carry
                # their own table row.
                n0 = self.allocator.blocks_for(len(seq))
                ids += [self.allocator.alloc_reserved()
                        for _ in range(n0 - len(shared))]
            if self.fused_prefill:
                if pos0 and cow_key is not None:
                    # the chain covers the whole padded prompt: copy its
                    # tail block into the slot's own, so re-scoring the
                    # last token writes no shared block
                    src = self.allocator.acquire(cow_key)
                    if src is None:  # revival refused: shrink the hit
                        pos0 = len(shared) * self.block_size
                    else:
                        self._copy_pool_block(ids[-1], src)
                        self.allocator.free([src])
            else:
                # dense and hybrid layouts never hit (the cache needs the
                # same layer gate as fused prefill): the staging cache
                # starts empty
                staging = self.model.init_cache(1, self.cache_len,
                                                device=self.device)
            if pos0:
                self.n_prefix_hits += 1
                self.n_prefix_hit_tokens += pos0
            self.slots[slot] = _Slot(
                request_id=w.request_id, remaining=w.max_new,
                submit_s=w.submit_s, admit_s=self._now(), blocks=ids,
                n_outstanding=reserved - (n0 - len(shared)),
                n_shared=len(shared), seq_tokens=seq, base_len=base_len,
                prefill_pos=pos0, staging=staging,
                requested_new=w.requested_new, truncated=w.truncated,
                n_preempted=w.n_preempted, first_token_s=w.first_token_s,
                pad=pad)
            self.pos[slot] = 0
            self.n_admitted += 1
            n += 1
            if self.on_state is not None:
                self.on_state(w.request_id, "prefill")
        return n

    def _admit_inline(self, w: _WaitingReq, free: List[int]) -> bool:
        """Admit the frontend prompt at the head of the queue by one-shot
        prefill (its embeds cannot go through chunks): reserve its
        worst-case blocks (paged), prefill the frontend span and the
        bucketed prompt at once, and graft the prefill cache into freshly
        allocated blocks or into the slot's dense row. The slot decodes
        from position F + S at once; every resident decode waits for the
        whole prefill, as in the reference. Returns False, leaving the
        queue as it was, when the reservation cannot be met."""
        reserved = 0
        if self.kv_layout == "paged":
            reserved = self.request_blocks(len(w.prompt), w.max_new)
            if not self.allocator.reserve(reserved):
                return False
        self.waiting.pop(0)
        slot = free.pop(0)
        batch, S, _ = make_prefill_batch(self.cfg, [w.prompt])
        self.prefill_shapes.add(tuple(batch["tokens"].shape))
        logits, one_cache = self.model.prefill(
            self.params, {k: self._upload(v) for k, v in batch.items()})
        F = self._frontend_tokens()
        ids: List[int] = []
        if self.kv_layout == "paged":
            n0 = self.allocator.blocks_for(F + S)
            ids = [self.allocator.alloc_reserved() for _ in range(n0)]
            self.block_tables[slot, :n0] = ids
            self._graft(one_cache, slot, block_ids=ids)
        else:
            self._graft(one_cache, slot)
        self.slots[slot] = _Slot(
            request_id=w.request_id, remaining=w.max_new,
            submit_s=w.submit_s, admit_s=self._now(), blocks=ids,
            n_outstanding=reserved - len(ids),
            requested_new=w.requested_new, truncated=w.truncated,
            pad=S - len(w.prompt))
        self.pos[slot] = F + S
        self.pending_tok[slot] = int(self._readback(logits[0, -1, :],
                                                    w.request_id))
        self.n_admitted += 1
        if self.on_state is not None:
            # one-shot prefill: the slot decodes the moment admission
            # returns (queued -> decode)
            self.on_state(w.request_id, "decode")
        return True

    def _admit_swap(self, w: _WaitingReq, free: List[int]) -> bool:
        """Admit the swap resume at the head of the queue: reserve its
        whole remaining footprint, allocate device blocks for the swapped
        ones and start their host-to-device copy (``_swap_in_blocks``;
        the next forward waits for it), release the host blocks, and hand
        the slot to the decode loop at its carried frontier: no prefill.
        Returns False, leaving the queue as it was, when the reservation
        cannot be met."""
        req = w.swap
        need = self.allocator.blocks_for(req.pos + req.max_new)
        if not self.allocator.reserve(need):
            return False
        self.waiting.pop(0)
        slot = free.pop(0)
        n_have = len(req.host_blocks)
        ids = [self.allocator.alloc_reserved() for _ in range(n_have)]
        self._swap_in_blocks(req.host_blocks, ids)
        self.allocator.host_free(req.host_blocks)
        self.allocator.n_swapped_in += n_have
        self.block_tables[slot, :n_have] = ids
        # prefill_pos == len(seq_tokens): decoding from the first step,
        # the mapped blocks already hold rows [0, pos)
        self.slots[slot] = _Slot(
            request_id=w.request_id, remaining=req.max_new,
            tokens=list(req.tokens), submit_s=req.submit_s,
            admit_s=self._now(), blocks=ids, n_outstanding=need - n_have,
            n_shared=0, seq_tokens=np.asarray(req.seq_tokens, np.int32),
            base_len=req.base_len, prefill_pos=len(req.seq_tokens),
            requested_new=req.requested_new, truncated=req.truncated,
            n_preempted=req.n_preempted, first_token_s=req.first_token_s,
            pad=w.pad)
        self.pos[slot] = req.pos
        self.pending_tok[slot] = req.pending_tok
        if self.prefix_cache:
            # the prompt's blocks came back bit for bit: publish again
            # any key that fell out of both tiers meanwhile (the first
            # writer wins, so keys cached elsewhere stay)
            for i, key in enumerate(self._chain_keys(
                    self.slots[slot].seq_tokens)):
                if i < n_have:
                    self.allocator.register(key, ids[i])
        self.n_admitted += 1
        self.n_swap_resumes += 1
        if self.on_state is not None:
            self.on_state(w.request_id, "decode")
        return True

    # ---- host KV tier: the swap data plane -------------------------------
    def _make_host_pool(self) -> List[Dict[str, torch.Tensor]]:
        """Host mirror of the paged pool: per layer a k and a v tensor of
        ``kv_host_blocks + 1`` blocks (host ids index it directly; row 0
        is dead, as the device null block). On a GPU it is pinned, and so
        is a staging area of ``min(blocks_per_slot, kv_host_blocks)``
        blocks per pool (no transfer moves more: a slot holds at most
        ``blocks_per_slot`` blocks) that every transfer goes through, so
        copies run asynchronously and no transfer pays a pinned
        allocation. Built only where every layer is paged (``swap_ok``)."""
        pin = self.device.type == "cuda"
        cap = min(self.blocks_per_slot, self.kv_host_blocks)

        def host(n, like):
            return torch.zeros((n,) + tuple(like.shape[1:]), dtype=like.dtype,
                               pin_memory=pin)
        self._staging = [{key: host(cap, c[key]) for key in ("k", "v")}
                         for c in self.cache] if pin else None
        return [{key: host(self.kv_host_blocks + 1, c[key])
                 for key in ("k", "v")} for c in self.cache]

    @property
    def swap_bytes_per_block(self) -> int:
        """Bytes one block holds over every paged layer's K and V: the
        unit the swap-cost fit prices."""
        if self.host_pool is None:
            return 0
        return sum(h[key][0].numel() * h[key].element_size()
                   for h in self.host_pool for key in ("k", "v"))

    def _staging_free(self) -> None:
        """Wait for the last swap-in's copy out of the staging area, so
        the next transfer may overwrite it."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None

    def _swap_out_blocks(self, dev_ids: List[int],
                         host_ids: List[int]) -> None:
        """Copy pool blocks ``dev_ids`` into host blocks ``host_ids``: per
        pool one gather on the device and, on a GPU, one copy into the
        pinned staging area, then a synchronize, so the (bytes, ms)
        sample measures the finished transfer; the rows then land in the
        host pool."""
        t0 = time.perf_counter()
        n = len(dev_ids)
        didx = self._int_tensor(dev_ids).long()
        hidx = torch.as_tensor(host_ids, dtype=torch.long)
        staged = []
        if self.device.type == "cuda":
            self._staging_free()
            for c, st in zip(self.cache, self._staging):
                for key in ("k", "v"):
                    st[key][:n].copy_(c[key].index_select(0, didx),
                                      non_blocking=True)
                    staged.append(st[key][:n])
            torch.cuda.current_stream(self.device).synchronize()
        else:
            staged = [c[key].index_select(0, didx) for c in self.cache
                      for key in ("k", "v")]
        n_bytes = 0
        for h, rows in zip((h[key] for h in self.host_pool
                            for key in ("k", "v")), staged):
            h.index_copy_(0, hidx, rows)
            n_bytes += rows.numel() * rows.element_size()
        self.swap_samples.append(
            (n_bytes, (time.perf_counter() - t0) * 1e3))

    def _swap_in_blocks(self, host_ids: List[int],
                        dev_ids: List[int]) -> None:
        """Copy host blocks ``host_ids`` into device blocks ``dev_ids``.
        On a GPU the rows are gathered into the pinned staging area (so
        the host blocks may be handed out again at once), copied without
        blocking on a side stream, and scattered into the pool on the
        current stream after it waits for that copy: the transfer overlaps
        the host's bookkeeping up to the next forward, and the sample is
        the dispatch's host time, as the reference's. The staging area is
        reused only once the copy has left it (``_staging_free``). On the
        CPU the copy is direct."""
        t0 = time.perf_counter()
        n = len(host_ids)
        didx = self._int_tensor(dev_ids).long()
        hidx = torch.as_tensor(host_ids, dtype=torch.long)
        n_bytes = 0
        if self.device.type != "cuda":
            for c, h in zip(self.cache, self.host_pool):
                for key in ("k", "v"):
                    rows = h[key].index_select(0, hidx)
                    c[key].index_copy_(0, didx, rows)
                    n_bytes += rows.numel() * rows.element_size()
        else:
            self._staging_free()
            cur = torch.cuda.current_stream(self.device)
            if self._swap_stream is None:
                self._swap_stream = torch.cuda.Stream(self.device)
            side = self._swap_stream
            side.wait_stream(cur)
            moved = []
            with torch.cuda.stream(side):
                for c, h, st in zip(self.cache, self.host_pool,
                                    self._staging):
                    for key in ("k", "v"):
                        rows = st[key][:n]
                        torch.index_select(h[key], 0, hidx, out=rows)
                        moved.append((c[key], rows.to(self.device,
                                                      non_blocking=True)))
                        n_bytes += rows.numel() * rows.element_size()
                self._staged = side.record_event()
            cur.wait_stream(side)
            for pool, dev in moved:
                dev.record_stream(cur)
                pool.index_copy_(0, didx, dev)
        self.swap_samples.append(
            (n_bytes, (time.perf_counter() - t0) * 1e3))

    def _spill_block(self, bid: int, hid: int) -> None:
        """Allocator hook: demote one reclaimed prefix block to host."""
        self._swap_out_blocks([bid], [hid])

    def _unspill_block(self, hid: int, bid: int) -> None:
        """Allocator hook: revive one spilled prefix block."""
        self._swap_in_blocks([hid], [bid])

    # ---- chunked prefill (docs/ARCHITECTURE.md §5) -----------------------
    def _int_tensor(self, a: np.ndarray, request: int = -1) -> torch.Tensor:
        return self._upload(np.ascontiguousarray(a, np.int32), request)

    def _upload(self, a: np.ndarray, request: int = -1) -> torch.Tensor:
        """``a`` on the engine's device. From pageable host memory the
        copy blocks: the host waits for the stream to drain. Counted in
        ``n_host_syncs`` on every device, and an ``upload`` span while
        tracing (``serving/tracing.py``)."""
        self.n_host_syncs += 1
        tr = self._tr
        if tr is None:
            return torch.from_numpy(a).to(self.device)
        sp = tr.open("upload", request, bytes=a.nbytes)
        out = torch.from_numpy(a).to(self.device)
        tr.close(sp)
        return out

    def _readback(self, logits: torch.Tensor, request: int = -1
                  ) -> np.ndarray:
        """``sample_tokens(logits)``: the greedy tokens on the host, which
        waits for the stream to drain. Counted in ``n_host_syncs``; while
        tracing a ``readback`` span, and the drained stream anchors the
        next step's device intervals."""
        self.n_host_syncs += 1
        tr = self._tr
        if tr is None:
            return sample_tokens(logits)
        sp = tr.open("readback", request)
        out = sample_tokens(logits)
        tr.close(sp)
        tr.readback_done()
        return out

    def _prefill_step(self, budget_left: int) -> int:
        """Advance in-slot chunked prefills by at most ``budget_left``
        tokens, in power-of-two pieces of at most ``_MAX_CHUNK``. Fused:
        each chunk runs directly against the pool through a table row
        built from the slot's blocks, attending shared prefix blocks in
        place. Otherwise each chunk runs against the slot's staging
        cache. A slot whose last chunk lands joins the decode batch of
        this same iteration. Returns tokens processed."""
        done_tokens = 0
        tr = self._tr
        for i in list(self.prefilling_slots):
            s = self.slots[i]
            rid = s.request_id
            logits = None
            while s.prefilling and budget_left > 0:
                rem = len(s.seq_tokens) - s.prefill_pos
                c = min(rem, budget_left, _MAX_CHUNK)
                c = 1 << (c.bit_length() - 1)  # largest power of two <= c
                toks = s.seq_tokens[s.prefill_pos:s.prefill_pos + c]
                self.prefill_shapes.add((c, self.cache_len))
                batch = {"tokens": self._int_tensor(toks[None, :], rid),
                         "pos": self._int_tensor([s.prefill_pos], rid)}
                if self.fused_prefill:
                    tbl = np.zeros((1, self.blocks_per_slot), np.int32)
                    tbl[0, :len(s.blocks)] = s.blocks
                    batch["block_tables"] = self._int_tensor(tbl, rid)
                fw = None if tr is None else tr.forward(
                    "prefill", rid, **tracing.piece(
                        c, s.prefill_pos, s.pad, len(s.seq_tokens)))
                if self.fused_prefill:
                    logits, self.cache = self.model.prefill_chunk(
                        self.params, self.cache, batch)
                else:
                    logits, s.staging = self.model.prefill_chunk(
                        self.params, s.staging, batch)
                if fw is not None:
                    tr.forward_done(fw)
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
        (paged), graft the staging cache into the slot (unfused layouts;
        shared blocks are skipped), publish the full prompt blocks under
        their chain keys (prefix cache), and hand the slot to the decode
        loop."""
        s = self.slots[slot]
        if self.kv_layout == "paged":
            self.block_tables[slot, :len(s.blocks)] = s.blocks
            if not self.fused_prefill:
                self._graft(s.staging, slot, block_ids=s.blocks,
                            skip_blocks=s.n_shared)
            if self.prefix_cache:
                for i, key in enumerate(self._chain_keys(s.seq_tokens)):
                    if i >= s.n_shared:
                        self.allocator.register(key, s.blocks[i])
        else:
            self._graft(s.staging, slot)
        s.staging = None
        self.pos[slot] = s.prefill_pos
        self.pending_tok[slot] = int(self._readback(logits[0, -1, :],
                                                    s.request_id))
        if self.on_state is not None:
            self.on_state(s.request_id, "decode")

    def _graft(self, one_cache: List[Dict], slot: int,
               block_ids: Optional[List[int]] = None,
               skip_blocks: int = 0) -> None:
        """Copy a prefilled one-slot staging cache into the engine's
        cache, in place. A paged layer (``block_ids`` given) scatters the
        staging rows its blocks cover into those blocks, past the first
        ``skip_blocks`` (prefix-cache blocks mapped shared, which already
        hold the right content); the rows past the prompt are zeros.
        Every other leaf (dense K/V rows, rings, and a recurrent layer's
        state: ``h`` and ``conv``; ``att_state``, ``att_shift`` and
        ``ffn_shift``) replaces row ``slot`` whole: the staging cache has
        the row's shape (a dense slab's speculation margin past
        ``cache_len`` excepted, which is zeroed), prefill wrote [0, S)
        and the rest is zeros. Under a mesh, every rank's cache from its
        rank's staging cache."""
        kinds = self.cfg.layer_kinds()
        for rank, one_rank in zip(self._ranks(self.cache),
                                  self._ranks(one_cache)):
            self._graft_rank(kinds, rank, one_rank, slot, block_ids,
                             skip_blocks)

    def _graft_rank(self, kinds, cache: List[Dict], one_cache: List[Dict],
                    slot: int, block_ids: Optional[List[int]],
                    skip_blocks: int) -> None:
        for kind, full, one in zip(kinds, cache, one_cache):
            if block_ids is not None and paged_layer_kind(self.cfg, kind):
                ids = self._int_tensor(block_ids[skip_blocks:]).to(
                    full["k"].device)
                start = skip_blocks * self.block_size
                cap = len(block_ids) * self.block_size
                for key in ("k", "v"):
                    scatter_blocks(full[key], one[key][0, start:cap], ids)
                continue
            for key, t in full.items():
                row = one[key][0]
                if row.shape != t.shape[1:]:
                    t[slot, row.shape[0]:].zero_()
                t[slot, :row.shape[0]].copy_(row)

    # ---- preemption ------------------------------------------------------
    def preemption_candidates(self) -> List[Tuple[int, int, int]]:
        """(slot, request_id, freeable blocks) for every preemptible
        resident: decoding slots only, never a mid-chunk prefill (its
        chunks would be thrown away and bought again at once). A block
        other sequences also map (refcount > 1) frees no capacity when
        this slot drops its reference, so only sole-reference blocks and
        the unconsumed rest of the reservation count as freeable. An
        engine without the chunked path (a frontend model) has none."""
        if not self.chunked:
            return []
        out = []
        for i, s in enumerate(self.slots):
            if not s.active or s.prefilling:
                continue
            freeable = s.n_outstanding
            if self.kv_layout == "paged":
                freeable += sum(1 for b in s.blocks
                                if self.allocator.refcount(b) == 1)
            out.append((i, s.request_id, freeable))
        return out

    def can_swap(self, slot: int) -> bool:
        """Could the sequence in ``slot`` be preempted with
        ``mode="swap"`` now? It needs the host tier (``swap_ok``: built,
        and every layer paged), a decoding sequence, and enough available
        host blocks for its KV."""
        if not self.swap_ok:
            return False
        s = self.slots[slot]
        return s.active and not s.prefilling \
            and self.allocator.n_host_available >= len(s.blocks)

    def _emitted(self, s: _Slot) -> List[int]:
        """Every token ``s`` has emitted: those before a preemption live
        in the re-prefilled context, the rest in ``s.tokens``."""
        if s.seq_tokens is not None and s.base_len < len(s.seq_tokens):
            return [int(t) for t in s.seq_tokens[s.base_len:]] + s.tokens
        return s.tokens

    def _free_slot(self, i: int, reset_pos: bool = True) -> None:
        """Drop slot ``i``'s block references (a registered block parks in
        the prefix cache's LRU pool at refcount 0) and the unconsumed rest
        of its reservation (paged), and empty the slot."""
        s = self.slots[i]
        if self.kv_layout == "paged":
            self.allocator.free(s.blocks)
            self.allocator.unreserve(s.n_outstanding)
            self.block_tables[i, :] = 0
        if reset_pos:
            self.pos[i] = 0
        self.slots[i] = _Slot()

    def preempt(self, slot: int, requeue: bool = True,
                mode: str = "recompute") -> PreemptedRequest:
        """Evict the decoding sequence in ``slot``, returning its blocks
        and the unconsumed rest of its reservation at once.

        ``mode="recompute"``: the snapshot resumes by re-prefilling the
        padded prompt plus every token emitted so far, so greedy output
        is token-identical to an uninterrupted run. ``mode="swap"``: the
        slot's blocks are copied to the host tier first
        (``_swap_out_blocks``), and resume maps them back with no
        recompute; the emitted tokens, the position and the pending token
        ride in the snapshot. It raises where ``can_swap`` does not hold:
        callers price and pick the mode, the engine never falls back.
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
        if not self.chunked:
            raise NotImplementedError(
                "preemption needs the chunked-prefill path "
                "(plain token prompts)")
        if mode == "swap":
            if not self.can_swap(slot):
                raise ValueError(
                    f"slot {slot} is not swappable (host tier off, "
                    "non-pageable stack, or host pool full)")
            host_ids = self.allocator.swap_out_alloc(len(s.blocks))
            assert host_ids is not None  # can_swap checked availability
            self._swap_out_blocks(s.blocks, host_ids)
            req = PreemptedRequest(
                s.request_id, s.seq_tokens, base_len=s.base_len,
                max_new=s.remaining, submit_s=s.submit_s,
                requested_new=s.requested_new, truncated=s.truncated,
                n_preempted=s.n_preempted + 1,
                first_token_s=s.first_token_s, tokens=list(s.tokens),
                pos=int(self.pos[slot]),
                pending_tok=int(self.pending_tok[slot]),
                host_blocks=host_ids, host_engine_id=id(self), pad=s.pad)
            self.n_swap_preempts += 1
        else:
            req = PreemptedRequest(
                s.request_id, np.concatenate(
                    [s.seq_tokens, np.asarray(s.tokens, np.int32)]),
                base_len=s.base_len, max_new=s.remaining,
                submit_s=s.submit_s, requested_new=s.requested_new,
                truncated=s.truncated, n_preempted=s.n_preempted + 1,
                first_token_s=s.first_token_s, pad=s.pad)
        self._free_slot(slot)
        self.n_preempted += 1
        if requeue:
            self.waiting.insert(0, _WaitingReq(
                req.request_id, req.seq_tokens, req.max_new, req.submit_s,
                prepadded=True, base_len=req.base_len,
                requested_new=req.requested_new, truncated=req.truncated,
                n_preempted=req.n_preempted,
                first_token_s=req.first_token_s,
                swap=req if req.swapped else None, pad=req.pad))
        return req

    def release_swap(self, req: PreemptedRequest) -> PreemptedRequest:
        """Convert a swap snapshot back into a recompute snapshot, freeing
        its host blocks: the way out when the engine holding them drains
        and the snapshot must resume elsewhere. The recompute context is
        the padded prompt plus the emitted tokens, and greedy re-prefill
        regenerates the dropped pending token. A recompute snapshot is
        returned as it is; a snapshot of another engine raises."""
        if not req.swapped:
            return req
        if req.host_engine_id != id(self):
            raise ValueError(
                "swap snapshot is pinned to a different engine's host "
                "pool")
        self.allocator.host_free(req.host_blocks)
        return to_recompute(req)

    # ---- cancellation ----------------------------------------------------
    def cancel(self, request_id: int) -> Optional[ContinuousResult]:
        """Tear ``request_id`` down at whatever phase it is in (queued,
        mid-chunk prefill, decoding, or queued again after a preemption)
        and free its memory before returning: its block references
        (shared prefix blocks included) go back to the allocator and the
        unconsumed rest of its reservation is cancelled. Nothing of a
        mid-prefill sequence was registered yet, so no key can reference
        its partly written blocks. Returns a ``ContinuousResult`` with ``cancelled=True``
        carrying the partial completion, or ``None`` when the id is not
        live here (finished already, or resident elsewhere in a pool)."""
        for qi, w in enumerate(self.waiting):
            if w.request_id != request_id:
                continue
            self.waiting.pop(qi)
            # a requeued preemption carries its earlier tokens in the
            # prepadded context (recompute) or in the swap snapshot, whose
            # host blocks free here; a fresh prompt has none
            if w.swap is not None:
                self.allocator.host_free(w.swap.host_blocks)
                emitted = np.asarray(w.swap.tokens, np.int32)
            else:
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
                n_preempted=s.n_preempted,
                n_spec_proposed=s.n_spec_proposed,
                n_spec_accepted=s.n_spec_accepted,
                first_token_s=s.first_token_s, cancelled=True)
            self._free_slot(i)
            self.n_cancelled += 1
            self.n_evicted += 1
            return res
        return None

    # ---- iteration -------------------------------------------------------
    def _release(self, i: int) -> None:
        """Evict the finished slot ``i``. Paged: free-on-evict, blocks
        return to the pool and the unconsumed tail of the reservation is
        cancelled. A dense slot keeps its position, as in the reference:
        its idle row's dummy decode writes stay where the reference's do
        (the next admission's graft overwrites the row)."""
        self._free_slot(i, reset_pos=self.kv_layout == "paged")
        self.n_evicted += 1

    def _result(self, s: _Slot, now: float) -> ContinuousResult:
        """The finished sequence ``s`` as a ``ContinuousResult``."""
        emitted = self._emitted(s)
        return ContinuousResult(
            s.request_id, np.asarray(emitted, np.int32),
            submit_s=s.submit_s, admit_s=s.admit_s, finish_s=now,
            n_iters=len(emitted), truncated=s.truncated,
            n_preempted=s.n_preempted, n_spec_proposed=s.n_spec_proposed,
            n_spec_accepted=s.n_spec_accepted,
            first_token_s=s.first_token_s)

    def _alloc_through(self, i: int, top: int) -> None:
        """Map blocks into slot ``i`` until they cover position ``top``
        (alloc on the block boundary; the admission reservation
        guarantees the allocation cannot fail)."""
        s = self.slots[i]
        while top >= len(s.blocks) * self.block_size:
            bid = self.allocator.alloc_reserved()
            s.n_outstanding -= 1
            self.block_tables[i, len(s.blocks)] = bid
            s.blocks.append(bid)

    def step(self) -> List[ContinuousResult]:
        """One engine iteration: admit, advance chunked prefills under the
        per-iteration token budget, then ONE decode iteration over all
        slots (a speculative one where ``_effective_spec_k`` is above 0);
        evicts after. The budget caps prefill-chunk plus resident decode
        tokens, ``1 + k`` a slot when speculating. Returns the sequences
        that finished. Inactive slots decode a dummy token at position 0
        (into the null block, or their own row, which admission's graft
        overwrites), keeping the decode shape fixed at (n_slots, 1).

        While a ``torch.profiler`` session runs in this thread the step
        records its spans (``serving/tracing.py``); otherwise it records
        nothing."""
        loads = _build.n_loads
        if torch.autograd._profiler_enabled():
            tr = self._tr = tracing.StepTrace(self, self.n_iters,
                                              self._anchor)
            try:
                finished = self._step()
            finally:
                self._tr = None
                self._anchor = tr.finish()
        else:
            self._anchor = None
            finished = self._step()
        self.last_step_compiled = _build.n_loads != loads
        return finished

    def _step(self) -> List[ContinuousResult]:
        tr = self._tr
        if tr is None:
            self.admit()
        else:
            sp = tr.open("admit")
            sp.attrs["slots"] = self.admit()
            tr.close(sp)
        n_dec = len(self.decoding_slots)
        budget = self.token_budget if self.token_budget is not None \
            else 1 << 62
        eff_k = self._effective_spec_k(n_dec, budget)
        self.last_step_tokens = self._prefill_step(
            max(0, budget - n_dec * (1 + eff_k)))
        active = self.decoding_slots
        if not active:
            return []
        if eff_k > 0:
            return self._step_speculative(active, eff_k)
        self.last_step_tokens += len(active)
        for i in active:
            s = self.slots[i]
            s.tokens.append(int(self.pending_tok[i]))
            s.remaining -= 1
            self._note_tokens(s, 1)
        batch = {"tokens": self._int_tensor(self.pending_tok[:, None]),
                 "pos": self._int_tensor(self.pos)}
        if self.kv_layout == "paged":
            # the write at ``pos`` needs its block mapped before the
            # decode runs
            for i in active:
                self._alloc_through(i, int(self.pos[i]))
            batch["block_tables"] = self._int_tensor(self.block_tables)
        fw = None if tr is None else tr.forward(
            "decode", rows=self.n_slots,
            contexts_active=[int(self.pos[i]) + 1 for i in active],
            real_contexts=[int(self.pos[i]) + 1 - self.slots[i].pad
                           for i in active])
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    batch)
        if fw is not None:
            tr.forward_done(fw)
        nxt = self._readback(logits[:, -1, :])
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
                finished.append(self._result(s, now))
                self._release(i)
            else:
                self.pending_tok[i] = nxt[i]
                self.pos[i] = self.pos[i] + 1
        return finished

    # ---- speculative decoding --------------------------------------------
    def _effective_spec_k(self, n_dec: int, budget: int) -> int:
        """The speculation depth this iteration runs: ``spec_k`` clamped
        to ``spec_max``, cut so that ``n_dec * (1 + k)`` decode tokens fit
        the iteration's token budget (down to 0 before prefill work
        starves; the scheduler's guard degrades the same way ahead of
        time)."""
        k = min(max(0, self.spec_k), self.spec_max)
        if k and n_dec and self.token_budget is not None:
            k = max(0, min(k, budget // n_dec - 1))
        return k

    def _step_speculative(self, active: List[int],
                          k: int) -> List[ContinuousResult]:
        """One speculative iteration over the decoding slots: propose up
        to ``k`` drafts per slot from its own context, score the pending
        token and the drafts in ONE ``(n_slots, 1 + k)`` verify forward,
        read its argmax back once, accept the longest draft prefix that
        matches it, and roll the rest back: dense rows past the frontier
        are masked by ``pos`` until overwritten, paged blocks past it go
        back to the allocator (``_trim_blocks``). Acceptance is greedy
        equality, so every emitted token is the argmax a sequential
        decode would have produced.

        The verify writes start at ``pos``, past every shared or
        registered prefix block, so rollback frees only sole-reference
        decode blocks. Rows ``j > k_i`` of a slot (its cap, below) land in
        blocks of its own reservation, the null columns or the dense
        margin, and their logits are ignored."""
        W = 1 + k
        toks = np.zeros((self.n_slots, W), np.int32)
        k_eff: Dict[int, int] = {}
        for i in active:
            s = self.slots[i]
            # never draft past the tokens still owed or the logical cache
            ki = max(0, min(k, s.remaining - 1,
                            self.cache_len - 1 - int(self.pos[i])))
            k_eff[i] = ki
            toks[i, 0] = self.pending_tok[i]
            if ki > 0:
                context = np.concatenate(
                    [s.seq_tokens, np.asarray(s.tokens, np.int32),
                     [self.pending_tok[i]]]).astype(np.int32)
                toks[i, 1:1 + ki] = self.proposer.propose(context, ki)
        batch = {"tokens": self._int_tensor(toks),
                 "pos": self._int_tensor(self.pos)}
        if self.kv_layout == "paged":
            # map blocks through each slot's deepest draft row (inside the
            # admission reservation: pos + k_i is within the granted
            # footprint), then widen the table by null columns so rows
            # past cache_len land in the null block
            for i in active:
                self._alloc_through(i, int(self.pos[i]) + k_eff[i])
            pad = -(-self.spec_max // self.block_size)
            vt = np.zeros((self.n_slots, self.blocks_per_slot + pad),
                          np.int32)
            vt[:, :self.blocks_per_slot] = self.block_tables
            batch["block_tables"] = self._int_tensor(vt)
        tr = self._tr
        fw = None if tr is None else tr.forward("verify", rows=self.n_slots,
                                                width=W)
        logits, self.cache = self.model.verify_step(self.params, self.cache,
                                                    batch)
        if fw is not None:
            tr.forward_done(fw)
        nxt_all = self._readback(logits)  # (n_slots, W): one readback
        self.n_iters += 1
        self.n_spec_steps += 1
        finished: List[ContinuousResult] = []
        now = self._now()
        for i in active:
            s = self.slots[i]
            ki = k_eff[i]
            a = 0
            while a < ki and toks[i, a + 1] == nxt_all[i, a]:
                a += 1
            self.n_spec_proposed += ki
            self.n_spec_accepted += a
            s.n_spec_proposed += ki
            s.n_spec_accepted += a
            self.last_step_tokens += 1 + ki
            # emit the pending token and the accepted drafts
            s.tokens.extend(int(t) for t in toks[i, :a + 1])
            s.remaining -= a + 1
            self._note_tokens(s, a + 1)
            new_pos = int(self.pos[i]) + a + 1
            if self.kv_layout == "paged":
                self._trim_blocks(i, new_pos)
            if new_pos >= self.cache_len and s.remaining > 0:
                s.truncated = True
                s.remaining = 0
            if s.remaining <= 0:
                finished.append(self._result(s, now))
                self._release(i)
            else:
                # the model's token after the accepted prefix: what a
                # sequential decode would hold as the new pending token
                self.pending_tok[i] = nxt_all[i, a]
                self.pos[i] = new_pos
        return finished

    def _trim_blocks(self, slot: int, pos: int) -> None:
        """Block-granular KV rollback: free the blocks past the last
        committed row ``pos - 1`` and restore the reservation, leaving the
        block list an unspeculated decode at ``pos`` would hold. Only
        sole-reference decode blocks are trimmed: shared and registered
        prefix blocks lie below the prefill length, which ``pos`` never
        rolls back past."""
        s = self.slots[slot]
        keep = self.allocator.blocks_for(pos)
        if keep >= len(s.blocks):
            return
        drop = s.blocks[keep:]
        for b in drop:
            assert self.allocator.refcount(b) == 1, \
                f"rollback would free block {b} with refcount " \
                f"{self.allocator.refcount(b)}"
        del s.blocks[keep:]
        self.block_tables[slot, keep:keep + len(drop)] = 0
        self.allocator.free(drop)
        ok = self.allocator.reserve(len(drop))
        assert ok, "re-reserving just-freed blocks cannot fail"
        s.n_outstanding += len(drop)

    def rollback(self, slot: int, n: int) -> None:
        """Undo the last ``n`` emitted tokens of the sequence in ``slot``:
        the context shrinks by ``n``, the pending token becomes the first
        undone one, and (paged) the blocks past the new frontier go back
        to the allocator with the reservation restored. Decoding on from
        there is token-identical: greedy decode is deterministic, and rows
        at or past ``pos`` are overwritten before they are attended."""
        if not supports_speculation(self.cfg):
            raise ValueError(
                f"{self.cfg.name}: rollback needs rewindable decode "
                "state (linear attention only)")
        s = self.slots[slot]
        if not s.active or s.prefilling:
            raise ValueError(f"slot {slot} is not decoding")
        if not 1 <= n <= len(s.tokens):
            raise ValueError(
                f"can roll back 1..{len(s.tokens)} tokens, got {n}")
        new_pos = int(self.pos[slot]) - n
        self.pending_tok[slot] = s.tokens[-n]
        del s.tokens[-n:]
        s.remaining += n
        self.pos[slot] = new_pos
        if self.kv_layout == "paged":
            self._trim_blocks(slot, new_pos)

    @property
    def spec_accept_rate(self) -> float:
        """Drafts accepted over drafts proposed in the engine's lifetime
        (0.0 before any speculative step): the scheduler's feature."""
        return self.n_spec_accepted / self.n_spec_proposed \
            if self.n_spec_proposed else 0.0

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
        """Distinct physical cache positions live sequences occupy: per
        block under the paged layout, a shared block counted once
        (``kv_used_tokens`` stays per sequence, so under sharing it can
        exceed this). A mid-prefill slot of an unfused (hybrid) layout
        holds nothing in the pool until its graft."""
        if self.kv_layout != "paged":
            return self.kv_used_tokens
        bs = self.block_size
        cov: Dict[int, int] = {}
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            if s.prefilling:
                c = s.prefill_pos if self.fused_prefill \
                    else min(s.prefill_pos, s.n_shared * bs)
            else:
                c = int(self.pos[i]) + 1
            for idx, bid in enumerate(s.blocks):
                t = min(bs, c - idx * bs)
                if t <= 0:
                    break
                cov[bid] = max(cov.get(bid, 0), t)
        return sum(cov.values())

    @property
    def kv_shared_frac(self) -> float:
        """Fraction of live block mappings backed by a physical block some
        other sequence also maps: 1 - distinct/logical (0 without
        sharing)."""
        logical, distinct = self.kv_block_mapping()
        return 1.0 - distinct / logical if logical else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Prompt tokens served from the prefix cache as a fraction of all
        prompt tokens processed (hit + chunked prefill) over the engine's
        lifetime."""
        total = self.n_prefix_hit_tokens + self.n_prefill_chunk_tokens
        return self.n_prefix_hit_tokens / total if total else 0.0

    @property
    def kv_free_tokens(self) -> int:
        """Admission headroom in tokens: unreserved blocks (paged) or
        free slots x cache_len (dense)."""
        if self.kv_layout == "paged":
            return self.allocator.n_available * self.block_size
        return len(self.free_slots) * self.cache_len

    def stats(self) -> Dict[str, float]:
        """Counters + KV occupancy metrics (the reference's keys for the
        features the port has, plus ``n_prefill_chunks``, ``n_host_syncs``
        and the span recorder's drops, ``n_spans_dropped``).
        ``kv_waste_frac`` counts a shared block once; ``kv_used_tokens``
        stays per sequence, so used over allocated can pass 1 under
        sharing: the capacity the prefix cache buys."""
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
            "kv_cached_tokens": float(
                self.allocator.n_cached * self.block_size
                if self.kv_layout == "paged" else 0),
            "kv_shared_frac": self.kv_shared_frac,
            "prefix_hit_rate": self.prefix_hit_rate,
            "n_prefix_hits": float(self.n_prefix_hits),
            "queue_depth": float(len(self.waiting)),
            "n_preempted": float(self.n_preempted),
            "n_cancelled": float(self.n_cancelled),
            "kv_host_blocks": float(self.kv_host_blocks),
            "kv_host_free": float(self.allocator.n_host_free
                                  if self.kv_layout == "paged" else 0),
            "kv_host_live": float(self.allocator.n_host_live
                                  if self.kv_layout == "paged" else 0),
            "kv_host_cached": float(self.allocator.n_host_cached
                                    if self.kv_layout == "paged" else 0),
            "n_swap_preempts": float(self.n_swap_preempts),
            "n_swap_resumes": float(self.n_swap_resumes),
            "n_spilled": float(self.allocator.n_spilled
                               if self.kv_layout == "paged" else 0),
            "n_unspilled": float(self.allocator.n_unspilled
                                 if self.kv_layout == "paged" else 0),
            "prefill_backlog_tokens": float(self.prefill_backlog_tokens),
            "token_budget": float(self.token_budget or 0),
            "spec_k": float(min(max(0, self.spec_k), self.spec_max)),
            "spec_accept_rate": self.spec_accept_rate,
            "n_spec_proposed": float(self.n_spec_proposed),
            "n_spec_accepted": float(self.n_spec_accepted),
            "n_spec_steps": float(self.n_spec_steps),
            "tp_degree": float(self.tp_degree),
            "n_host_syncs": float(self.n_host_syncs),
            "n_spans_dropped": float(tracing.RECORDER.n_dropped),
        }
