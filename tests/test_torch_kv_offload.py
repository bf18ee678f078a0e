"""The port's host KV tier against the reference's, on the CPU: the tests
of tests/test_kv_offload.py (the allocator's host tier, swap preemption
and prefix spill in the engine, the pool's recompute-or-swap choice and
its accounting fixes), each run on the reference and on the port with
the reference's weights bridged in, under the same schedule.

Compared: the allocators' whole state, host tier included (free list,
swapped set, spilled keys and their LRU order, counters), after every
operation; greedy tokens, which a swap resume keeps identical to an
uninterrupted run; the bytes of spilled and revived blocks, which come
back exactly; and the pools' preemption counts, modes and results. The
pool tests freeze both pools' clocks and pin the contention fit, since
preemption reads both. Tolerance: exact everywhere (a swap copies bytes;
the tokens are greedy).
"""
import dataclasses
import heapq
import random

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY, make_pool
from repro.serving.engine import BlockAllocator as JaxAllocator
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import PreemptedRequest as JaxPreempted
from repro.serving.runtime import PoolRequest as JaxPoolRequest
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.serving import latency_model as lm
from repro_torch.serving.bcedge import POOL_STATE_DIM, PoolScheduler
from repro_torch.serving.engine import (BlockAllocator,
                                        ContinuousBatchingEngine,
                                        ContinuousResult, PreemptedRequest,
                                        to_recompute)
from repro_torch.serving.runtime import ModelInstancePool, PoolRequest

VOCAB = TINY.vocab_size
TTINY = ModelConfig(**dataclasses.asdict(TINY))
#: the contention fit both pools are pinned to (t1 ms, c)
FIT = (5.0, 0.1)
_TEMPLATE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(rng, n):
    return rng.integers(1, VOCAB, n).astype(np.int32)


def _params():
    if "params" not in _TEMPLATE:
        je = JaxEngine(TINY, max_slots=1, max_seq=64, seed=0)
        _TEMPLATE["engine"] = je
        _TEMPLATE["params"] = jax.tree.map(np.asarray, je.params)
    return _TEMPLATE["engine"], _TEMPLATE["params"]


def _alloc_state(al):
    return (list(al._free), sorted(al._outstanding), dict(al._refcount),
            dict(al._cache), dict(al._block_key), list(al._lru),
            al.n_reserved, al.n_reclaimed, list(al._host_free),
            sorted(al._host_live), dict(al._host_cache),
            dict(al._host_key), list(al._host_lru), al.n_spilled,
            al.n_unspilled, al.n_host_reclaimed, al.n_swapped_out)


def _swap_engines(cfg=TINY, **kw):
    """(reference engine, port engine) with the suite's host-tier shape:
    2 slots, 64-token cache, blocks of 8, 24 device and 16 host blocks,
    the prefix cache on."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("block_size", 8)
    kw.setdefault("kv_blocks", 24)
    kw.setdefault("kv_host_blocks", 16)
    kw.setdefault("prefix_cache", True)
    tmpl, params = _params()
    share = {"share_from": tmpl} if cfg is TINY else {}
    je = JaxEngine(cfg, seed=0, **share, **kw)
    te = ContinuousBatchingEngine(ModelConfig(**dataclasses.asdict(cfg)),
                                  device="cpu", **kw)
    if cfg is TINY:
        te.load_jax_params(params)
    return je, te


class _Lock:
    """Both engines driven by the same calls; every call compares the
    results and the allocators' whole state."""

    def __init__(self, **kw):
        self.ref, self.port = _swap_engines(**kw)

    def _both(self, fn):
        want, got = fn(self.ref), fn(self.port)
        if self.port.allocator is not None:
            assert _alloc_state(self.port.allocator) == \
                _alloc_state(self.ref.allocator)
        return want, got

    def submit(self, p, n):
        want, got = self._both(lambda e: e.submit(p, max_new_tokens=n))
        assert got == want
        return got

    def step(self):
        want, got = self._both(lambda e: {r.request_id: r.tokens.tolist()
                                          for r in e.step()})
        assert got == want
        return got

    def run(self, prompts, n):
        want, got = self._both(lambda e: [r.tokens.tolist()
                                          for r in e.run(prompts, n)])
        assert got == want
        return got

    def drain(self):
        out = {}
        while self.ref.waiting or self.ref.active_slots:
            out.update(self.step())
        assert not (self.port.waiting or self.port.active_slots)
        return out


# ---------------------------------------------------------------- allocator
def _apply(al, call):
    """One allocator operation; returns its result or the exception
    type it raised."""
    op, *args = call
    try:
        if op == "alloc":
            return al.alloc_reserved() if al.reserve(1) else None
        return getattr(al, op)(*args)
    except (ValueError, AssertionError) as e:
        return type(e)


def test_host_tier_allocator_in_lockstep():
    """Seeded random operations (allocate, free, register, acquire, swap
    out, host free) on both allocators, whose spill and revival hooks
    record their moves: the same results, exceptions and state (host id
    sets, spilled keys, LRU order, counters) after every operation, and
    the same moves."""
    spilled = unspilled = 0
    for seed in range(6):
        rng = random.Random(seed)
        ref = JaxAllocator(10, 8, host_blocks=5)
        port = BlockAllocator(10, 8, host_blocks=5)
        moves = {id(ref): [], id(port): []}
        for al in (ref, port):
            m = moves[id(al)]
            al.spill_fn = lambda b, h, _m=m: _m.append(("spill", b, h))
            al.unspill_fn = lambda h, b, _m=m: _m.append(("unspill", h, b))
        keys = [f"k{i}" for i in range(12)]
        swapped = []
        for _ in range(400):
            r = rng.random()
            live = sorted(ref._outstanding)
            if r < 0.3 or (r < 0.6 and not live):
                call = ("alloc",)
            elif r < 0.45:
                call = ("free", [rng.choice(live)])
            elif r < 0.6:
                call = ("register", rng.choice(keys), rng.choice(live))
            elif r < 0.78:
                call = ("acquire", rng.choice(keys))
            elif r < 0.9 or not swapped:
                call = ("swap_out_alloc", rng.randint(1, 3))
            else:
                call = ("host_free", swapped.pop(rng.randrange(
                    len(swapped))))
            want, got = _apply(ref, call), _apply(port, call)
            assert got == want, (seed, call)
            assert _alloc_state(port) == _alloc_state(ref), (seed, call)
            if call[0] == "swap_out_alloc" and isinstance(got, list):
                swapped.append(got)
            free, cached = set(port._host_free), \
                set(port._host_cache.values())
            assert len(free) + len(cached) + port.n_host_live \
                == port.n_host_blocks
        assert moves[id(port)] == moves[id(ref)]
        spilled += port.n_spilled
        unspilled += port.n_unspilled
    assert spilled > 0 and unspilled > 0


# ---------------------------------------------------------------- engine
def test_ctor_validation():
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(TTINY, kv_layout="paged", block_size=8,
                                 kv_host_blocks=-1, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(TTINY, kv_host_blocks=8, device="cpu")
    # a stack that cannot page every layer builds the tier, never swaps
    rg = ModelConfig(**dataclasses.asdict(KIND_CFGS["rglru"]))
    eng = ContinuousBatchingEngine(rg, kv_layout="paged", block_size=8,
                                   kv_host_blocks=8, device="cpu")
    assert not eng.swap_ok and eng.host_pool is None
    assert eng.allocator.n_host_blocks == 8


def test_swap_resume_token_identical_and_no_leak():
    """Swap resume == recompute resume == uninterrupted on both engines,
    their states equal after every call, both tiers conserved."""
    rng = np.random.default_rng(0)
    p = _prompt(rng, 20)
    want = _Lock().run([p], 12)[0]
    for mode in ("recompute", "swap"):
        eng = _Lock()
        eng.submit(p, 12)
        for _ in range(5):
            eng.step()
        slot = eng.port.decoding_slots[0]
        snaps = eng._both(lambda e: e.preempt(slot, requeue=False,
                                              mode=mode))
        for s in snaps:
            assert s.swapped == (mode == "swap")
        assert (snaps[0].host_blocks, snaps[0].pos, snaps[0].pending_tok,
                snaps[0].tokens) == (snaps[1].host_blocks, snaps[1].pos,
                                     snaps[1].pending_tok, snaps[1].tokens)
        for _ in range(2):
            eng.step()
        rids = (eng.ref.submit_resume(snaps[0]),
                eng.port.submit_resume(snaps[1]))
        assert rids[0] == rids[1]
        out = eng.drain()
        assert out[rids[1]] == want, mode
        al = eng.port.allocator
        assert al.n_live == 0 and al.n_reserved == 0
        assert al.n_host_live == 0
        assert al.n_host_free + al.n_host_cached == al.n_host_blocks
        if mode == "swap":
            assert al.n_swapped_out == al.n_swapped_in > 0
    assert _swap_engines()[1].n_swap_preempts == 0


def test_swap_preempt_counts_and_samples():
    rng = np.random.default_rng(1)
    eng = _Lock()
    eng.submit(_prompt(rng, 16), 8)
    for _ in range(4):
        eng.step()
    eng._both(lambda e: e.preempt(e.decoding_slots[0], mode="swap"))
    for e in (eng.ref, eng.port):
        assert e.n_swap_preempts == 1
        assert e.swap_samples and e.swap_samples[-1][0] > 0
    # the bytes moved: every block of every layer's k and v
    n_blocks = len(eng.port.waiting[0].swap.host_blocks)
    assert eng.port.swap_samples[-1][0] == eng.ref.swap_samples[-1][0] \
        == n_blocks * eng.port.swap_bytes_per_block \
        == n_blocks * eng.ref.swap_bytes_per_block
    eng.drain()
    for e in (eng.ref, eng.port):
        assert e.n_swap_resumes == 1
        assert e.allocator.n_host_live == 0
    keys = ("n_swap_preempts", "n_swap_resumes", "kv_host_blocks",
            "kv_host_free", "kv_host_live", "kv_host_cached", "n_spilled",
            "n_unspilled")
    got, want = eng.port.stats(), eng.ref.stats()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_swap_requires_host_capacity():
    """mode="swap" raises, never falls back, when the host tier cannot
    hold the victim."""
    rng = np.random.default_rng(2)
    eng = _Lock(kv_host_blocks=1)
    eng.submit(_prompt(rng, 20), 8)
    for _ in range(3):
        eng.step()
    slot = eng.port.decoding_slots[0]
    for e in (eng.ref, eng.port):
        assert not e.can_swap(slot)
        with pytest.raises(ValueError, match="not swappable"):
            e.preempt(slot, mode="swap")


def _block_bytes(te, bid):
    return [(c["k"][bid].clone(), c["v"][bid].clone()) for c in te.cache]


def test_prefix_spill_to_host_and_revival():
    """Cold prefix blocks spill to the host tier on LRU reclaim instead
    of being invalidated, a later same-prefix prompt revives them with
    the same tokens, and the revived blocks hold the original bytes."""
    rng = np.random.default_rng(3)
    prefix = _prompt(rng, 16)
    pa = np.concatenate([prefix, _prompt(rng, 4)])
    pb = np.concatenate([prefix, _prompt(rng, 4)])
    fillers = [_prompt(rng, 24), _prompt(rng, 24)]
    eng = _Lock(max_slots=1, kv_blocks=6, kv_host_blocks=16)
    te = eng.port
    want_a = eng.run([pa], 4)[0]
    keys = te._chain_keys(te._padded_seq(pa))
    orig = {k: _block_bytes(te, te.allocator._cache[k]) for k in keys}
    for f in fillers:
        eng.run([f], 4)
    assert te.allocator.n_spilled > 0, "reclaim never spilled"
    assert any(k in te.allocator._host_cache for k in keys)
    # a spilled block's host rows are the device bytes it left
    for k in keys:
        hid = te.allocator._host_cache.get(k)
        if hid is not None:
            for (dk, dv), h in zip(orig[k], te.host_pool):
                assert torch.equal(h["k"][hid], dk)
                assert torch.equal(h["v"][hid], dv)
    tokens_b = eng.run([pb], 4)[0]
    assert te.allocator.n_unspilled > 0, "revival never unspilled"
    for k in keys:
        bid = te.allocator._cache.get(k)
        if bid is not None:
            for (dk, dv), c in zip(orig[k], te.cache):
                assert torch.equal(c["k"][bid], dk)
                assert torch.equal(c["v"][bid], dv)
    assert eng.run([pa], 4)[0] == want_a
    fresh = _Lock(max_slots=1, kv_blocks=6, kv_host_blocks=16)
    assert fresh.run([pb], 4)[0] == tokens_b
    a = te.allocator
    assert a.n_host_free + a.n_host_cached + a.n_host_live \
        == a.n_host_blocks


def test_cancel_waiting_swap_snapshot_frees_host_blocks():
    rng = np.random.default_rng(4)
    eng = _Lock()
    rid = eng.submit(_prompt(rng, 16), 8)
    for _ in range(4):
        eng.step()
    eng._both(lambda e: e.preempt(e.decoding_slots[0], mode="swap"))
    assert eng.port.allocator.n_host_live > 0
    want, got = eng._both(lambda e: e.cancel(rid))
    assert got.cancelled and len(got.tokens) > 0
    assert got.tokens.tolist() == want.tokens.tolist()
    al = eng.port.allocator
    assert al.n_host_live == 0
    assert al.n_host_free + al.n_host_cached == al.n_host_blocks


def test_release_swap_and_pinning():
    """release_swap turns a swap snapshot into a recompute one, freeing
    its host blocks; another engine refuses both release and resume."""
    rng = np.random.default_rng(5)
    p = _prompt(rng, 16)
    want = _Lock().run([p], 8)[0]
    eng = _Lock()
    eng.submit(p, 8)
    for _ in range(4):
        eng.step()
    snaps = eng._both(lambda e: e.preempt(e.decoding_slots[0],
                                          requeue=False, mode="swap"))
    others = _swap_engines()
    for other, snap in zip(others, snaps):
        with pytest.raises(ValueError, match="host"):
            other.submit_resume(snap)
        with pytest.raises(ValueError, match="host pool"):
            other.release_swap(snap)
    recs = [e.release_swap(s) for e, s in zip((eng.ref, eng.port), snaps)]
    assert _alloc_state(eng.port.allocator) == \
        _alloc_state(eng.ref.allocator)
    for e, rec in zip((eng.ref, eng.port), recs):
        assert not rec.swapped and e.allocator.n_host_live == 0
    np.testing.assert_array_equal(recs[0].seq_tokens, recs[1].seq_tokens)
    for other, rec in zip(others, recs):
        rid = other.submit_resume(rec)
        out = {}
        while other.waiting or other.active_slots:
            for r in other.step():
                out[r.request_id] = r.tokens.tolist()
        assert out[rid] == want


def test_to_recompute_without_engine():
    """The module-level fallback rebuilds a recompute snapshot from the
    carried tokens, as the reference's."""
    kw = dict(request_id=7, seq_tokens=np.arange(1, 9, dtype=np.int32),
              base_len=8, max_new=3, submit_s=0.0, requested_new=5,
              truncated=False, n_preempted=1, tokens=[11, 12], pos=10,
              pending_tok=0, host_blocks=[1, 2], host_engine_id=123)
    rec = to_recompute(PreemptedRequest(**kw))
    assert not rec.swapped
    np.testing.assert_array_equal(
        rec.seq_tokens, np.array([1, 2, 3, 4, 5, 6, 7, 8, 11, 12]))
    assert rec.base_len == 8 and rec.max_new == 3
    from repro.serving.engine import to_recompute as jax_to_recompute
    want = jax_to_recompute(JaxPreempted(**kw))
    np.testing.assert_array_equal(rec.seq_tokens, want.seq_tokens)
    assert (rec.base_len, rec.max_new) == (want.base_len, want.max_new)


# ------------------------------------------------------------------ pool
def _swap_pools(monkeypatch, preempt_mode="auto", **kw):
    """(reference pool, port pool): the suite's host-tier pool with one
    running instance each on the reference's weights, clocks frozen and
    contention pinned, after a two-request drain."""
    kw.setdefault("max_instances", 2)
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("preemption", True)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("block_size", 8)
    kw.setdefault("kv_block_budget", 64)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("kv_host_blocks", 16)
    ref = make_pool(TINY, preempt_mode=preempt_mode, **kw)
    port = ModelInstancePool({"tiny": TTINY}, device="cpu",
                             preempt_mode=preempt_mode, **kw)
    clock = [1.0]
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: clock[0])
        monkeypatch.setattr(pool, "contention", lambda: FIT)
        pool.scale_to("tiny", 1)
    port.load_jax_params("tiny", jax.tree.map(
        np.asarray, ref.running("tiny")[0].engine.params))
    rng = np.random.default_rng(3)
    warm = [_prompt(rng, 6) for _ in range(2)]
    for pool in (ref, port):
        for p in warm:
            pool.submit("tiny", p, slo_ms=60_000.0, max_new_tokens=8)
        pool.run_until_drained()
    return ref, port, rng, clock


def _preempt_once(pool, rng_state, hog_new=24):
    """The hog, six steps, then an urgent request (``rng_state`` gives
    both pools the same prompts)."""
    rng = np.random.default_rng(rng_state)
    hog = pool.submit("tiny", _prompt(rng, 8), slo_ms=60_000.0,
                      max_new_tokens=hog_new)
    for _ in range(6):
        pool.step()
    urgent = pool.submit("tiny", _prompt(rng, 6), slo_ms=0.001,
                         max_new_tokens=2)
    return hog, urgent


def _results(pool):
    return {r.request_id: (r.tokens.tolist(), r.instance_id, r.cancelled)
            for r in pool.results("tiny")}


@pytest.mark.parametrize("mode,swaps", [("recompute", 0), ("swap", 1),
                                        ("auto", 1)])
def test_pool_preempt_mode(mode, swaps, monkeypatch):
    """Forced modes obey the flag; auto swaps while the swap fit is
    uncalibrated. Either way the hog resumes and emits every token, on
    both pools alike."""
    ref, port, _, _ = _swap_pools(monkeypatch, preempt_mode=mode)
    out = []
    for pool in (ref, port):
        hog, urgent = _preempt_once(pool, 7)
        pool.run_until_drained()
        by_id = {r.request_id: r for r in pool.results("tiny")}
        assert pool.n_preempted == 1
        assert pool.n_swap_preempted == swaps
        assert len(by_id[hog].tokens) == 24
        assert len(by_id[urgent].tokens) == 2
        assert pool.stats()["n_swap_preempted"] == float(swaps)
        for inst in pool.live():
            a = inst.engine.allocator
            assert a.n_host_live == 0
            assert a.n_host_free + a.n_host_cached == a.n_host_blocks
        out.append((_results(pool), list(pool.admission_log)))
    assert out[1] == out[0]


def test_pool_auto_mode_prices_with_calibrated_fits(monkeypatch):
    """With both fits set, auto takes the cheaper side, on both pools:
    swap when recompute is dear, recompute when swapping is."""
    for (tok, swap, want) in (((0.0, 1000.0), (0.01, 0.01), 1),
                              ((0.0, 0.0001), (10_000.0, 10_000.0), 0)):
        ref, port, _, _ = _swap_pools(monkeypatch, preempt_mode="auto")
        for pool in (ref, port):
            pool.token_cost = lambda tp_degree=None, _t=tok: _t
            pool.swap_cost = lambda _s=swap: _s
            _preempt_once(pool, 7)
            pool.run_until_drained()
            assert pool.n_preempted == 1
            assert pool.n_swap_preempted == want
        assert _results(port) == _results(ref)


def test_pool_swap_cancel_frees_host_blocks(monkeypatch):
    ref, port, _, _ = _swap_pools(monkeypatch, preempt_mode="swap")
    toks = []
    for pool in (ref, port):
        hog, _ = _preempt_once(pool, 7)
        res = pool.cancel(hog)  # a queued swap snapshot
        assert res is not None and res.cancelled and len(res.tokens) > 0
        toks.append(res.tokens.tolist())
        pool.run_until_drained()
        for inst in pool.live():
            assert inst.engine.allocator.n_host_live == 0
    assert toks[1] == toks[0]


def test_pool_swap_survives_source_retire(monkeypatch):
    """A swap snapshot whose source engine retires falls back to
    recompute and still finishes with every token; the respawned model
    starts with clean preemption bookkeeping."""
    ref, port, _, _ = _swap_pools(monkeypatch, preempt_mode="swap")
    out = []
    for pool in (ref, port):
        hog, _ = _preempt_once(pool, 7)
        for _ in range(30):
            pool.step()
            if not any(i.n_resident for i in pool.live()):
                break
        pool.scale_to("tiny", 0)
        while pool.live():
            pool.step()
        assert pool.n_swap_preempted == 1
        assert pool.preempts_by_model["tiny"] == 0
        assert "tiny" not in pool._last_preempt_step
        pool.scale_to("tiny", 1)
        pool.run_until_drained()
        by_id = {r.request_id: r for r in pool.results("tiny")}
        assert len(by_id[hog].tokens) == 24, "swap snapshot lost tokens"
        out.append(by_id[hog].tokens.tolist())
    assert out[1] == out[0]


def test_pool_state_has_host_feature(monkeypatch):
    _, port, _, _ = _swap_pools(monkeypatch)
    scfg = ServingConfig(batch_sizes=(1,), concurrency_levels=(1,))
    sched = PoolScheduler(port, scfg, slo_ms={"tiny": 1000.0},
                          learn=False, seed=0)
    s = sched._state("tiny")
    assert s.shape == (POOL_STATE_DIM,)
    occ = port.kv_occupancy()
    assert {"host_blocks", "host_free", "host_live", "host_cached",
            "host_frac"} <= set(occ)
    assert occ["host_blocks"] == 16.0
    assert s[-1] == pytest.approx(min(1.0, max(0.0, occ["host_frac"])))
    assert s[10] == pytest.approx(port.spec_accept_rate())


def test_swap_cost_fit_is_the_references():
    """``fit_swap_cost`` and ``predicted_swap_ms`` equal the reference's
    on the same samples, and recover a linear transfer model."""
    from repro.serving import latency_model as jlm

    rng = np.random.default_rng(0)
    for n in (0, 1, 5):
        samples = [(int(b), float(0.3 + 0.02 * b / 1e6
                                  + rng.normal() * 0.01))
                   for b in rng.integers(1e5, 4e7, n)]
        assert lm.fit_swap_cost(samples) == jlm.fit_swap_cost(samples)
    base, per_mb = lm.fit_swap_cost([(4e6, 1.0), (8e6, 1.5), (16e6, 2.5)])
    assert base == pytest.approx(0.5) and per_mb == pytest.approx(0.125)
    assert lm.predicted_swap_ms(base, per_mb, 4.0) == pytest.approx(1.0)
    assert lm.predicted_swap_ms(base, per_mb, -1.0) == \
        jlm.predicted_swap_ms(base, per_mb, -1.0)


# ------------------------------------------- the accounting fixes
def test_headroom_prices_preempted_snapshots():
    """A queued snapshot adds its remaining work to the backlog: context
    re-prefill plus remaining decode when recomputed, remaining decode
    only when swapped, as in the reference."""
    out = []
    for pool, Req, Snap in (
            (make_pool(TINY, kv_layout="paged", block_size=8),
             JaxPoolRequest, JaxPreempted),
            (ModelInstancePool({"tiny": TTINY}, max_instances=2,
                               max_slots=2, max_seq=64, kv_layout="paged",
                               block_size=8, device="cpu"),
             PoolRequest, PreemptedRequest)):
        pool.scale_to("tiny", 1)
        pool.token_cost = lambda tp_degree=None: (1.0, 2.0)
        base = pool.admission_headroom("tiny", 8, 4)

        def _queued(resume):
            r = Req(999, "tiny", np.zeros((0,), np.int32), 1000.0, 64,
                    0.0, resume=resume)
            heapq.heappush(pool.queues["tiny"], (r.deadline_s, 0, r))
            h = pool.admission_headroom("tiny", 8, 4)
            pool.queues["tiny"].clear()
            return h

        rec = Snap(request_id=999, seq_tokens=np.zeros((40,), np.int32),
                   base_len=30, max_new=6, submit_s=0.0, requested_new=16,
                   truncated=False, n_preempted=1)
        h_rec = _queued(rec)
        assert h_rec["backlog_tokens"] - base["backlog_tokens"] == 46.0
        assert h_rec["retry_after_s"] > base["retry_after_s"]
        swp = Snap(request_id=999, seq_tokens=np.zeros((40,), np.int32),
                   base_len=40, max_new=6, submit_s=0.0, requested_new=16,
                   truncated=False, n_preempted=1, tokens=[1, 2], pos=42,
                   host_blocks=[1, 2, 3], host_engine_id=0)
        h_swp = _queued(swp)
        assert h_swp["backlog_tokens"] - base["backlog_tokens"] == 6.0
        out.append((base, h_rec, h_swp))
    assert out[1] == out[0]


def test_stats_exclude_cancelled_timings():
    """Cancelled requests' partial timings stay out of the TTFT and TPOT
    samples; a cancelled engine result reaching ``_finish`` is flagged
    and excluded too."""
    pool = ModelInstancePool({"tiny": TTINY}, max_instances=2, max_slots=2,
                             max_seq=64, device="cpu")
    pool.scale_to("tiny", 1)
    rng = np.random.default_rng(7)
    pool.submit("tiny", _prompt(rng, 6), max_new_tokens=6)
    pool.run_until_drained()
    n_before = len(pool.ttft_samples)
    assert n_before >= 1
    rid = pool.submit("tiny", _prompt(rng, 6), max_new_tokens=12)
    for _ in range(4):
        pool.step()
    res = pool.cancel(rid)
    assert res is not None and res.cancelled and res.first_token_s >= 0
    pool.run_until_drained()
    assert len(pool.ttft_samples) == n_before
    inst = pool.live()[0]
    pool.submit("tiny", _prompt(rng, 4), max_new_tokens=2)
    pool.step()
    erid, _ = next(iter(inst.requests.items()))
    fake = ContinuousResult(erid, np.array([1], np.int32), 0.0, 0.0, 1.0,
                            n_iters=1, first_token_s=0.5, cancelled=True)
    res = pool._finish(inst, fake)
    assert res.cancelled and res.utility == 0.0
    assert len(pool.ttft_samples) == n_before


def test_preempt_bookkeeping_cleared_on_retire():
    """Retiring the last instance clears the model's cooldown and
    preemption count, so a respawned model starts clean."""
    pool = ModelInstancePool({"tiny": TTINY}, max_instances=2, max_slots=2,
                             max_seq=64, preemption=True, device="cpu")
    pool.scale_to("tiny", 1)
    rng = np.random.default_rng(9)
    pool.submit("tiny", _prompt(rng, 6), max_new_tokens=2)
    pool.run_until_drained()
    pool.preempts_by_model["tiny"] = 5
    pool._last_preempt_step["tiny"] = pool.n_steps
    pool.scale_to("tiny", 0)
    while pool.live():
        pool.step()
    assert pool.preempts_by_model["tiny"] == 0
    assert "tiny" not in pool._last_preempt_step
    pool.scale_to("tiny", 1)
    assert pool.preempts_by_model["tiny"] == 0
