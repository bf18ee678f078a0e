"""The port's prefix cache against the reference's, on the CPU: the
refcounted ``BlockAllocator`` (the allocator tests of
tests/test_paged_kv.py, every operation applied to both allocators and
their whole state compared after it) and the engine and pool tests of
tests/test_prefix_cache.py, each run on the reference and on the port
under the same submit/step schedule with bridged weights.

Compared: greedy tokens, hit counts and hit rates, ``kv_shared_frac``,
the allocators' free lists, LRU pools, keys and refcounts, every slot's
blocks and prefill position, and the pool's instance per request.
Copy-on-write is checked on the bytes of the shared blocks, and the
pools' contents against the reference's. Tolerance: tokens and
allocator state exact; pool contents atol 1e-5 in fp32.
"""
import dataclasses
import os
import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import KIND_CFGS, TINY
from repro.serving.engine import BlockAllocator as JaxAllocator
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import \
    supports_prefix_cache as jax_supports_prefix_cache
from repro.serving.runtime import ModelInstancePool as JaxPool
from repro_torch.config.base import ModelConfig
from repro_torch.models.bridge import unstack_layers
from repro_torch.serving.engine import (BlockAllocator,
                                        ContinuousBatchingEngine,
                                        supports_prefix_cache)
from repro_torch.serving.runtime import ModelInstancePool

POOL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------------------ allocator
def _alloc_state(al):
    return (list(al._free), sorted(al._outstanding), dict(al._refcount),
            dict(al._cache), dict(al._block_key), list(al._lru),
            al.n_reserved, al.n_reclaimed, al.n_free, al.n_cached,
            al.n_live, al.n_available)


class _Both:
    """The reference's and the port's allocator driven together: every
    call goes to both, must return the same (or raise the same exception
    type), and leaves the same state."""

    def __init__(self, n_blocks, block_size):
        self.ref = JaxAllocator(n_blocks, block_size)
        self.port = BlockAllocator(n_blocks, block_size)

    def __getattr__(self, name):
        rv, pv = getattr(self.ref, name), getattr(self.port, name)
        if not callable(rv):
            assert rv == pv, name
            return pv

        def call(*args):
            errs = []
            outs = []
            for fn in (rv, pv):
                try:
                    outs.append(fn(*args))
                    errs.append(None)
                except (ValueError, AssertionError) as e:
                    outs.append(None)
                    errs.append(type(e))
            assert errs[0] == errs[1], (name, args, errs)
            assert outs[0] == outs[1], (name, args, outs)
            assert _alloc_state(self.ref) == _alloc_state(self.port), \
                (name, args)
            if errs[1] is not None:
                raise errs[1](f"{name}{args}")
            return outs[1]
        return call


def test_allocator_invariants():
    al = _Both(8, block_size=16)
    assert al.n_free == 8 and al.n_available == 8
    assert al.blocks_for(0) == 0
    assert al.blocks_for(1) == 1
    assert al.blocks_for(16) == 1
    assert al.blocks_for(17) == 2
    assert al.reserve(5)
    assert al.n_available == 3 and al.n_free == 8
    ids = [al.alloc_reserved() for _ in range(3)]
    assert len(set(ids)) == 3 and all(0 < i <= 8 for i in ids)
    assert al.n_free == 5 and al.n_reserved == 2 and al.n_available == 3
    assert not al.reserve(4)  # only 3 available
    al.free(ids)
    al.unreserve(2)
    assert al.n_free == 8 and al.n_available == 8 and al.n_reserved == 0


def test_allocator_never_hands_out_null_block():
    al = _Both(4, block_size=8)
    assert al.reserve(4)
    ids = [al.alloc_reserved() for _ in range(4)]
    assert sorted(ids) == [1, 2, 3, 4]  # id 0 (null) never allocated
    with pytest.raises(AssertionError):
        al.alloc_reserved()  # nothing reserved any more


def test_refcount_decrement_to_zero_frees_exactly_once():
    """A block shared by two sequences frees on the second release, and
    only once: unregistered blocks return to the free list, registered
    ones park in the LRU pool."""
    al = _Both(4, block_size=8)
    assert al.reserve(2)
    a, b = al.alloc_reserved(), al.alloc_reserved()
    al.register("k-a", a)
    assert al.acquire("k-a") == a and al.refcount(a) == 2
    assert al.n_live == 2  # refcounted blocks count once
    al.free([a])
    assert al.refcount(a) == 1 and al.n_live == 2
    al.free([a])
    assert al.refcount(a) == 0 and al.n_cached == 1 and al.n_free == 2
    al.free([b])
    assert al.n_free == 3 and al.n_cached == 1
    assert al.n_free + al.n_cached + al.n_live == al.n_blocks


def test_double_free_still_raises_under_sharing():
    al = _Both(4, block_size=8)
    assert al.reserve(1)
    a = al.alloc_reserved()
    al.register("k", a)
    assert al.acquire("k") == a    # refcount 2
    al.free([a])
    al.free([a])                   # refcount 0: parked in the LRU pool
    with pytest.raises(ValueError):
        al.free([a])
    with pytest.raises(ValueError):
        al.free([a, a])


def test_reserve_cancel_accounting_unchanged_by_cache_hits():
    al = _Both(8, block_size=8)
    assert al.reserve(3)
    ids = [al.alloc_reserved() for _ in range(3)]
    for i, bid in enumerate(ids):
        al.register(f"k{i}", bid)
    avail0, res0 = al.n_available, al.n_reserved
    assert al.reserve(2)
    shared = [al.acquire(f"k{i}") for i in range(3)]  # live: free hits
    assert shared == ids
    assert al.n_available == avail0 - 2
    assert al.n_reserved == res0 + 2
    al.unreserve(2)
    al.free(shared)
    assert al.n_available == avail0 and al.n_reserved == res0


def test_lru_reclaim_never_frees_live_blocks():
    al = _Both(4, block_size=8)
    assert al.reserve(4)
    ids = [al.alloc_reserved() for _ in range(4)]
    for i, bid in enumerate(ids):
        al.register(f"k{i}", bid)
    al.free(ids[:2])               # k0, k1 parked (that order)
    assert al.n_cached == 2 and al.n_free == 0
    assert al.reserve(1)
    assert al.alloc_reserved() == ids[0]   # the LRU-oldest: k0
    assert not al.cached("k0")
    assert al.cached("k1") and al.cached("k2") and al.cached("k3")
    assert al.cached_live("k2") and not al.cached_live("k1")
    assert al.n_reclaimed == 1


def test_acquire_refuses_lru_revival_that_breaks_reservations():
    al = _Both(2, block_size=8)
    assert al.reserve(1)
    a = al.alloc_reserved()
    al.register("k", a)
    al.free([a])                   # parked; free list has 1
    assert al.reserve(2)           # promises both remaining blocks
    assert al.n_available == 0
    assert al.acquire("k") is None  # revival would break the promise
    ids = [al.alloc_reserved(), al.alloc_reserved()]
    assert sorted(ids) == [1, 2]


@given(seed=st.integers(min_value=0, max_value=10_000))
@settings(max_examples=int(os.environ.get("FUZZ_MAX_EXAMPLES", "25")),
          deadline=None)
def test_allocator_conservation_under_random_ops(seed):
    """The reference's random reserve/alloc/free/register/acquire
    schedule on both allocators: identical state after every operation,
    conservation, non-negative availability and exact refcounts."""
    r = random.Random(seed)
    al = _Both(8, block_size=4)
    live = []          # [bid, refs] still owed frees
    registered = 0
    for _ in range(60):
        op = r.randrange(5)
        if op == 0 and al.n_available > 0:
            al.reserve(1)
        elif op == 1 and al.n_reserved > 0:
            live.append([al.alloc_reserved(), 1])
        elif op == 2 and live:
            ent = r.choice(live)
            al.free([ent[0]])
            ent[1] -= 1
            if ent[1] == 0:
                live.remove(ent)
        elif op == 3 and live:
            al.register(f"key-{registered}", r.choice(live)[0])
            registered += 1
        elif op == 4 and registered:
            bid = al.acquire(f"key-{r.randrange(registered)}")
            if bid is not None:
                for ent in live:
                    if ent[0] == bid:
                        ent[1] += 1
                        break
                else:
                    live.append([bid, 1])
        assert al.n_free + al.n_cached + al.n_live == al.n_blocks
        assert al.n_available >= 0
        assert al.n_reserved <= al.n_free + al.n_cached
        for bid, refs in live:
            assert al.refcount(bid) == refs
    for bid, refs in live:
        for _ in range(refs):
            al.free([bid])
    assert al.n_free + al.n_cached == al.n_blocks and al.n_live == 0


# ------------------------------------------------------------ engines
_TEMPLATES = {}


def _template(cfg):
    """One reference engine per config whose weights (and jit caches)
    every engine pair of this module shares."""
    if cfg.name not in _TEMPLATES:
        je = JaxEngine(cfg, max_slots=1, max_seq=128, seed=0)
        _TEMPLATES[cfg.name] = (je, jax.tree.map(np.asarray, je.params))
    return _TEMPLATES[cfg.name]


class _Pair:
    """The reference's and the port's paged engine (``TINY``, blocks of
    8) on the same weights, driven by the same calls. ``check()``
    compares their allocators, slots and stats."""

    def __init__(self, prefix_cache=True, cfg=TINY, **kw):
        kw.setdefault("max_slots", 4)
        kw.setdefault("max_seq", 128)
        kw = dict(kw, kv_layout="paged", block_size=8,
                  prefix_cache=prefix_cache)
        tmpl, params = _template(cfg)
        self.ref = JaxEngine(cfg, seed=0, share_from=tmpl, **kw)
        self.port = ContinuousBatchingEngine(_torch_cfg(cfg), device="cpu",
                                             **kw)
        self.port.load_jax_params(params)

    def submit(self, prompt, max_new_tokens=8):
        rid = self.ref.submit(prompt, max_new_tokens)
        assert self.port.submit(prompt, max_new_tokens) == rid
        return rid

    def step(self):
        want = {r.request_id: r.tokens.tolist() for r in self.ref.step()}
        got = {r.request_id: r.tokens.tolist() for r in self.port.step()}
        assert got == want
        self.check()
        return want

    def run(self, prompts, max_new_tokens=8):
        want = [r.tokens.tolist()
                for r in self.ref.run(prompts, max_new_tokens)]
        got = [r.tokens.tolist()
               for r in self.port.run(prompts, max_new_tokens)]
        assert got == want
        self.check()
        return want

    def drain(self):
        done = {}
        while self.ref.active_slots or self.ref.waiting:
            done.update(self.step())
        assert not (self.port.active_slots or self.port.waiting)
        return done

    def admissible(self, *args, **kw):
        want = self.ref.admissible(*args, **kw)
        assert self.port.admissible(*args, **kw) == want
        return want

    def check(self):
        ref, port = self.ref, self.port
        assert _alloc_state(port.allocator) == _alloc_state(ref.allocator)
        for a, b in zip(port.slots, ref.slots):
            assert (a.request_id, a.blocks, a.n_shared, a.n_outstanding,
                    a.prefill_pos) == (b.request_id, b.blocks, b.n_shared,
                                       b.n_outstanding, b.prefill_pos)
        np.testing.assert_array_equal(port.block_tables, ref.block_tables)
        got, want = port.stats(), ref.stats()
        shared = set(got) & set(want)
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
        assert port.kv_unique_used_tokens == ref.kv_unique_used_tokens

    def stats(self):
        return self.port.stats()

    def pools_match(self):
        ref = unstack_layers(jax.tree.map(np.asarray, self.ref.cache),
                             self.ref.cfg)
        for got, want in zip(self.port.cache, ref):
            for key in ("k", "v"):
                np.testing.assert_allclose(got[key].numpy(), want[key],
                                           atol=POOL_ATOL)


def _family(rng, n_prompts, prefix_len=24, tail_len=4):
    """Same-length prompts sharing one prefix (left-padding makes sharing
    length-sensitive, so the family keeps its tails equal-length)."""
    prefix = rng.integers(1, 97, prefix_len).astype(np.int32)
    return [np.concatenate([prefix,
                            rng.integers(1, 97, tail_len).astype(np.int32)])
            for _ in range(n_prompts)]


def test_prefix_cache_requires_paged_and_pageable_layers():
    for ctor, cfg in ((JaxEngine, TINY),
                      (ContinuousBatchingEngine, _torch_cfg(TINY))):
        kw = {} if ctor is JaxEngine else {"device": "cpu"}
        with pytest.raises(ValueError):
            ctor(cfg, max_slots=2, max_seq=64, prefix_cache=True, **kw)
    for kind, cfg in sorted(KIND_CFGS.items()):
        assert supports_prefix_cache(_torch_cfg(cfg)) \
            == jax_supports_prefix_cache(cfg), kind
    for kind in ("windowed", "rglru", "rwkv", "swa"):
        assert not supports_prefix_cache(_torch_cfg(KIND_CFGS[kind]))
        with pytest.raises(ValueError):
            ContinuousBatchingEngine(_torch_cfg(KIND_CFGS[kind]),
                                     max_slots=2, max_seq=64,
                                     kv_layout="paged", block_size=8,
                                     prefix_cache=True, device="cpu")
    assert supports_prefix_cache(_torch_cfg(TINY))
    assert supports_prefix_cache(_torch_cfg(KIND_CFGS["tail"]))


def test_sequential_same_prefix_hits_and_stays_token_identical():
    """The second same-prefix request skips the cached prefix and still
    emits the no-cache output, on both sides; the identical full prompt
    resubmitted is a full-cover hit whose tail block is copied, and the
    shared blocks' bytes are untouched by it."""
    rng = np.random.default_rng(0)
    prompts = _family(rng, 3)
    off = _Pair(prefix_cache=False)
    want = [off.run([p], max_new_tokens=6)[0] for p in prompts]
    eng = _Pair()
    for p, w in zip(prompts, want):
        assert eng.run([p], max_new_tokens=6)[0] == w
    s = eng.stats()
    assert s["n_prefix_hits"] == 2.0
    assert s["prefix_hit_rate"] > 0.4
    eng.pools_match()
    # full cover: snapshot every cached block's bytes, rerun, compare
    al = eng.port.allocator
    cached = sorted(al._block_key)
    before = [{k: c[k][cached].clone() for k in ("k", "v")}
              for c in eng.port.cache]
    hits = eng.port.n_prefix_hits
    assert eng.run([prompts[0]], max_new_tokens=6)[0] == want[0]
    assert eng.port.n_prefix_hits == hits + 1
    for c, b in zip(eng.port.cache, before):
        for k in ("k", "v"):
            assert torch.equal(c[k][cached], b[k])
    eng.pools_match()


def test_concurrent_sharing_maps_blocks_once():
    rng = np.random.default_rng(1)
    prompts = _family(rng, 4)
    eng = _Pair()
    eng.run([prompts[0]], max_new_tokens=2)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    eng.step()
    port = eng.port
    assert len(port.active_slots) == 4
    shared = [b for s in port.slots if s.active for b in s.blocks
              if port.allocator.refcount(b) > 1]
    assert shared, "no block is shared across residents"
    st_ = port.stats()
    assert st_["kv_shared_frac"] > 0.3
    assert st_["kv_used_tokens"] > st_["kv_allocated_tokens"]
    assert 0.0 <= st_["kv_waste_frac"] <= 1.0
    assert port.kv_block_mapping() == eng.ref.kv_block_mapping()
    eng.drain()
    eng.pools_match()
    al = port.allocator
    assert al.n_free + al.n_cached + al.n_live == al.n_blocks
    assert al.n_reserved == 0 and al.n_live == 0


def test_stats_count_shared_blocks_once():
    rng = np.random.default_rng(2)
    prompts = _family(rng, 3)
    eng = _Pair()
    eng.run([prompts[0]], max_new_tokens=2)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    port = eng.port
    st_ = port.stats()
    assert st_["kv_shared_frac"] > 0.0
    assert st_["kv_waste_frac"] >= 0.0
    assert port.kv_unique_used_tokens <= port.kv_allocated_tokens
    assert port.kv_used_tokens > port.kv_unique_used_tokens


def test_lru_reuse_and_reclaim_under_pressure():
    rng = np.random.default_rng(3)
    fam_a = _family(rng, 2)
    eng = _Pair(kv_blocks=12)  # tight: 96 tokens
    eng.run([fam_a[0]], max_new_tokens=4)
    assert eng.port.allocator.n_cached > 0
    eng.run([fam_a[1]], max_new_tokens=4)
    assert eng.stats()["n_prefix_hits"] >= 1.0
    for _ in range(4):
        eng.run([rng.integers(1, 97, 28).astype(np.int32)],
                max_new_tokens=4)
    al = eng.port.allocator
    assert al.n_reclaimed > 0
    assert al.n_free + al.n_cached + al.n_live == al.n_blocks
    eng.pools_match()


def test_admissible_discounts_live_shared_blocks():
    rng = np.random.default_rng(4)
    prompts = _family(rng, 2)
    eng = _Pair(kv_blocks=8)
    eng.run([prompts[0]], max_new_tokens=2)
    eng.submit(prompts[0], max_new_tokens=8)
    eng.step()
    assert eng.port.active_slots
    assert not eng.admissible(len(prompts[1]), 8)
    assert eng.admissible(len(prompts[1]), 8, prompt=prompts[1])


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_admission_capacity_gain_vs_no_cache(prefix_cache):
    """Under one tight block budget the port reaches the reference's
    peak residency at every step, with the cache on and off; the cache
    raises the peak."""
    rng = np.random.default_rng(5)
    prompts = _family(rng, 6)

    def peak(pc):
        eng = _Pair(prefix_cache=pc, kv_blocks=16, max_slots=6)
        eng.run([prompts[0]], max_new_tokens=2)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        top = 0
        while eng.ref.active_slots or eng.ref.waiting:
            eng.step()
            top = max(top, len(eng.port.active_slots))
        return top

    if prefix_cache:
        assert peak(True) > peak(False)
    else:
        assert peak(False) >= 1


def test_recompute_resume_maps_cached_blocks():
    """A recompute resume's context (padded prompt plus emitted tokens)
    maps the cached prompt blocks again instead of re-prefilling them,
    on both sides, with the uninterrupted run's tokens."""
    rng = np.random.default_rng(12)
    prompts = _family(rng, 2)
    off = _Pair(prefix_cache=False)
    want = off.run(prompts, max_new_tokens=8)
    eng = _Pair()
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    slot = eng.ref.decoding_slots[0]
    hits = eng.port.n_prefix_hits
    eng.ref.preempt(slot)
    eng.port.preempt(slot)
    eng.check()
    done = eng.drain()
    assert [done[i] for i in sorted(done)] == want
    assert eng.port.n_prefix_hits > hits
    eng.pools_match()


# ------------------------------------------------------------ pool
def _pools(cfgs, **kw):
    ref = JaxPool(cfgs, **kw)
    port = ModelInstancePool({m: _torch_cfg(c) for m, c in cfgs.items()},
                             device="cpu", **kw)
    return ref, port


def test_router_prefix_affinity_concentrates_same_prefix(monkeypatch):
    """Same-prefix requests go to the instance that holds the prefix, on
    both pools (frozen clocks: routing reads them)."""
    rng = np.random.default_rng(6)
    prompts = _family(rng, 3)
    ref, port = _pools({TINY.name: TINY}, max_instances=2, max_slots=4,
                       max_seq=64, kv_layout="paged", block_size=8,
                       kv_block_budget=64, prefix_cache=True, seed=0)
    out = []
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: 1.0)
        pool.scale_to(TINY.name, 2)
    port.load_jax_params(TINY.name, jax.tree.map(
        np.asarray, ref.running(TINY.name)[0].engine.params))
    for pool in (ref, port):
        first = pool.submit(TINY.name, prompts[0], slo_ms=60_000.0,
                            max_new_tokens=4, submit_s=1.0)
        pool.run_until_drained()
        rest = [pool.submit(TINY.name, p, slo_ms=60_000.0,
                            max_new_tokens=4, submit_s=1.0)
                for p in prompts[1:]]
        pool.run_until_drained()
        placed = dict(pool.admission_log)
        assert all(placed[r] == placed[first] for r in rest), placed
        assert pool.prefix_hit_rate() > 0.0
        toks = {r.request_id: r.tokens.tolist()
                for r in pool.results(TINY.name)}
        out.append((list(pool.admission_log), toks, pool.prefix_hit_rate(),
                    pool.kv_occupancy()["prefix_hit_rate"]))
    assert out[1] == out[0]


def test_pool_prefix_cache_skips_unsupported_models():
    """A mixed pool downgrades per model: the pageable model gets the
    cache, the recurrent one serves paged without it; both sides serve
    the same tokens."""
    cfgs = {TINY.name: TINY, KIND_CFGS["rglru"].name: KIND_CFGS["rglru"]}
    ref, port = _pools(cfgs, max_instances=2, max_slots=2, max_seq=64,
                       seed=0, kv_layout="paged", block_size=8,
                       prefix_cache=True)
    rng = np.random.default_rng(7)
    prompts = {m: rng.integers(1, 97, 10).astype(np.int32) for m in cfgs}
    got = []
    for pool in (ref, port):
        for m in cfgs:
            pool.scale_to(m, 1)
        if pool is port:
            for m in cfgs:
                port.load_jax_params(m, jax.tree.map(
                    np.asarray, ref.running(m)[0].engine.params))
        assert pool.running(TINY.name)[0].engine.prefix_cache
        assert not pool.running(KIND_CFGS["rglru"].name)[0] \
            .engine.prefix_cache
        for m in cfgs:
            pool.submit(m, prompts[m], slo_ms=60_000.0, max_new_tokens=4)
        res = pool.run_until_drained()
        assert len(res) == 2 and not any(r.rejected for r in res)
        got.append({r.model: r.tokens.tolist() for r in res})
    assert got[1] == got[0]
