"""Randomized differential harness: the port's continuous engine against
the reference's under the same seeded schedules, on the CPU.

The port of tests/test_engine_fuzz.py: each seeded schedule interleaves
submit / step / cancel (at whatever phase it catches a request: queued,
mid-prefill, decoding, preempted) / preempt-and-resume (recompute, or a
coin flip between recompute and swap where the engine has a host tier)
/ live speculation-depth retuning (where the engine speculates) over a
pool of mixed-length prompts with shared and divergent prefixes and one
exact duplicate (the copy-on-write path), across engine variants: dense
and paged layouts, the prefix cache on and off, a token budget on and
off in both layouts (the dense budget runs the staging path, the paged
one the fused path), tight block budgets that force LRU revivals and
reclaims, speculation at k up to 4 (with a budget and a tight pool
too), a host tier whose tight device budget forces prefix spills beside
swap preemption, and the reference's kitchen sink (prefix cache, tight
blocks, budget, speculation and a host tier at once).

Both engines share weights (the reference's, bridged) and take every
operation in lockstep. After EVERY operation:
* the same finished and cancelled results (tokens, flags) on both sides;
* the port's allocator state equals the reference's (free list, LRU pool,
  keys, refcounts, reservations, and the host tier's free list, swapped
  set, spilled keys and their LRU) and holds the invariants itself:
  ``n_free + n_cached + n_live == n_blocks`` over disjoint id sets,
  ``n_available >= 0``, refcount(b) == the slots mapping b, block tables
  mirror the slots, the null block is never mapped; with a host tier
  ``n_host_free + n_host_cached + n_host_live == n_host_blocks`` over
  disjoint id sets, the swapped set exactly the waiting swap snapshots'
  blocks;
* the same slot contents (request, blocks, shared prefix blocks, prefill
  position).
After the drain: every finished request equals an uninterrupted
single-request run of the port, a cancelled one emitted a prefix of it,
and every reference came back.

``TORCH_ENGINE_FUZZ_SCHEDULES`` raises the number of schedules per
variant (default 1, which keeps this module near 30 s on six workers).
"""
import dataclasses
import os
import random

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config.base import ModelConfig
from repro_torch.serving.engine import ContinuousBatchingEngine

N_SCHEDULES = int(os.environ.get("TORCH_ENGINE_FUZZ_SCHEDULES", "1"))
MAX_SEQ = 128
MAX_NEW_CHOICES = (2, 4, 7)

#: variant -> engine keywords beyond the layout's defaults; "prefix"
#: turns the prefix cache on where the stack pages every layer
VARIANTS = {
    "dense": {},
    "dense-budget": {"token_budget": 12},
    "paged": {"kv_layout": "paged"},
    "paged-prefix-budget": {"kv_layout": "paged", "prefix": True,
                            "token_budget": 12},
    "paged-prefix-tight": {"kv_layout": "paged", "prefix": True,
                           "kv_blocks": 14, "max_slots": 4},
    "paged-prefix-tight-budget": {"kv_layout": "paged", "prefix": True,
                                  "kv_blocks": 18, "token_budget": 12,
                                  "max_slots": 4},
    "paged-prefix-spec": {"kv_layout": "paged", "prefix": True,
                          "spec_k": 4},
    "paged-spec-tight-budget": {"kv_layout": "paged", "kv_blocks": 16,
                                "token_budget": 12, "spec_k": 4},
    "kitchen-sink": {"kv_layout": "paged", "prefix": True, "kv_blocks": 18,
                     "token_budget": 12, "kv_host_blocks": 10,
                     "spec_k": 4, "max_slots": 4},
    "offload": {"kv_layout": "paged", "prefix": True, "kv_blocks": 16,
                "kv_host_blocks": 12, "max_slots": 4},
}

_TEMPLATES = {}
_ORACLE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _template(cfg):
    """One reference engine (weights and jit caches) and one port engine
    (the bridged weights) per config, shared by every engine built."""
    if cfg.name not in _TEMPLATES:
        je = JaxEngine(cfg, max_slots=1, max_seq=MAX_SEQ, seed=0)
        te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=1,
                                      max_seq=MAX_SEQ, device="cpu")
        te.load_jax_params(jax.tree.map(np.asarray, je.params))
        _TEMPLATES[cfg.name] = (je, te)
    return _TEMPLATES[cfg.name]


def _engines(cfg, variant: str):
    kw = dict(VARIANTS[variant])
    prefix = kw.pop("prefix", False)
    kw.setdefault("max_slots", 3)
    if cfg.name not in ("tiny", "tiny-tail"):
        kw.pop("spec_k", None)  # only rewindable stacks speculate
    if kw.get("kv_layout") == "paged":
        kw["block_size"] = 8
        kw["prefix_cache"] = prefix and cfg.name in ("tiny", "tiny-tail")
    je_t, te_t = _template(cfg)
    je = JaxEngine(cfg, max_seq=MAX_SEQ, seed=0, share_from=je_t, **kw)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_seq=MAX_SEQ,
                                  device="cpu", share_from=te_t, **kw)
    return je, te


def _oracle(cfg, prompt: np.ndarray, max_new: int) -> list:
    """The port's uninterrupted single-request greedy run (memoized)."""
    key = (cfg.name, prompt.tobytes(), max_new)
    if key not in _ORACLE:
        eng = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=1,
                                       max_seq=MAX_SEQ, device="cpu",
                                       share_from=_template(cfg)[1])
        _ORACLE[key] = eng.run([prompt], max_new)[0].tokens.tolist()
    return _ORACLE[key]


def _prompt_pool(cfg):
    """Two shared-prefix families (equal and unequal tail lengths:
    unequal ones land at other pad offsets and must not share), four
    divergent one-offs and one exact duplicate (the full-cover
    copy-on-write path)."""
    rng = np.random.default_rng(99)
    v = cfg.vocab_size
    pool = []
    for _ in range(2):
        prefix = rng.integers(1, v, 24).astype(np.int32)
        for tail_len in (4, 4, 8):
            pool.append(np.concatenate(
                [prefix, rng.integers(1, v, tail_len).astype(np.int32)]))
    pool += [rng.integers(1, v, n).astype(np.int32) for n in (3, 9, 17, 30)]
    pool.append(pool[0].copy())
    return pool


def _alloc_state(al):
    return (list(al._free), sorted(al._outstanding), dict(al._refcount),
            dict(al._cache), list(al._lru), al.n_reserved, al.n_reclaimed,
            list(al._host_free), sorted(al._host_live),
            dict(al._host_cache), list(al._host_lru), al.n_spilled,
            al.n_unspilled)


def _check(je, te, ctx: str) -> None:
    """The port's engine state equals the reference's and holds the
    allocator invariants."""
    for a, b in zip(te.slots, je.slots):
        assert (a.request_id, a.blocks, a.n_shared, a.n_outstanding,
                a.prefill_pos, a.remaining) == \
            (b.request_id, b.blocks, b.n_shared, b.n_outstanding,
             b.prefill_pos, b.remaining), ctx
    assert [w.request_id for w in te.waiting] == \
        [w.request_id for w in je.waiting], ctx
    np.testing.assert_array_equal(te.pos[te.decoding_slots],
                                  je.pos[je.decoding_slots], err_msg=ctx)
    al = te.allocator
    if al is None:
        return
    assert _alloc_state(al) == _alloc_state(je.allocator), ctx
    free, lru, out = set(al._free), set(al._lru), set(al._outstanding)
    assert not (free & lru or free & out or lru & out), ctx
    assert len(free) + len(lru) + len(out) == al.n_blocks, ctx
    assert al.n_available >= 0, ctx
    counts = {}
    for s in te.slots:
        if s.active:
            assert len(set(s.blocks)) == len(s.blocks), ctx
            for b in s.blocks:
                counts[b] = counts.get(b, 0) + 1
    assert 0 not in counts, ctx
    assert all(al.refcount(b) == c for b, c in counts.items()), ctx
    assert set(counts) == out, ctx
    if al.n_host_blocks:
        hfree, hlive = set(al._host_free), set(al._host_live)
        hcache = set(al._host_cache.values())
        assert not (hfree & hcache or hfree & hlive or hcache & hlive), ctx
        assert len(hfree) + len(hcache) + len(hlive) == al.n_host_blocks, \
            ctx
        swap_ids = [b for w in te.waiting if w.swap is not None
                    for b in w.swap.host_blocks]
        assert len(swap_ids) == len(set(swap_ids)), ctx
        assert set(swap_ids) == hlive, ctx
    for i, s in enumerate(te.slots):
        if s.active and not s.prefilling:
            n = len(s.blocks)
            np.testing.assert_array_equal(te.block_tables[i, :n], s.blocks,
                                          err_msg=ctx)
            assert not te.block_tables[i, n:].any(), ctx
        else:
            assert not te.block_tables[i].any(), ctx
    np.testing.assert_array_equal(te.block_tables, je.block_tables,
                                  err_msg=ctx)


def _results(rs):
    return {r.request_id: (r.tokens.tolist(), r.cancelled, r.truncated)
            for r in rs}


def _run_schedule(cfg, variant: str, seed: int) -> None:
    rng = random.Random(seed)
    je, te = _engines(cfg, variant)
    prompts = _prompt_pool(cfg)
    expected, results, cancelled = {}, {}, set()
    ctx = f"cfg={cfg.name} variant={variant} seed={seed}"

    def step():
        want = _results(je.step())
        assert _results(te.step()) == want, ctx
        results.update(want)

    for _ in range(rng.randint(8, 18)):
        roll = rng.random()
        if roll < 0.40:
            p = rng.choice(prompts)
            mn = rng.choice(MAX_NEW_CHOICES)
            errs = []
            for eng in (je, te):
                try:
                    rid = eng.submit(p, max_new_tokens=mn)
                    errs.append(None)
                except ValueError:
                    errs.append(ValueError)
            assert errs[0] == errs[1], ctx
            if errs[0] is None:
                expected[rid] = (p, mn)
        elif roll < 0.75:
            step()
        elif roll < 0.85:
            live = sorted(set(expected) - set(results))
            if live:
                rid = rng.choice(live)
                want = _results([je.cancel(rid)])
                assert _results([te.cancel(rid)]) == want, ctx
                assert want[rid][1], f"{ctx}: cancel({rid}) did not land"
                results.update(want)
                cancelled.add(rid)
        elif roll < 0.92 and je.spec_max > 0:
            # the scheduler's fourth axis mid-flight
            je.spec_k = te.spec_k = rng.choice((0, 2, 4))
        else:
            cands = je.decoding_slots
            assert te.decoding_slots == cands, ctx
            if cands:
                slot = rng.choice(cands)
                assert te.can_swap(slot) == je.can_swap(slot), ctx
                # a host tier flips a coin between the two eviction modes:
                # both resume to the same uninterrupted oracle
                mode = "swap" if je.swap_ok and je.can_swap(slot) \
                    and rng.random() < 0.5 else "recompute"
                je.preempt(slot, mode=mode)
                te.preempt(slot, mode=mode)
        _check(je, te, ctx)

    guard = 600
    while (je.waiting or je.active_slots) and guard:
        step()
        _check(je, te, ctx)
        guard -= 1
    assert guard, f"{ctx}: engine failed to drain"
    assert not (te.waiting or te.active_slots), ctx
    assert set(results) == set(expected), ctx
    for rid, (p, mn) in expected.items():
        toks, was_cancelled, truncated = results[rid]
        oracle = _oracle(cfg, p, mn)
        if rid in cancelled:
            assert was_cancelled and toks == oracle[:len(toks)], \
                f"{ctx} rid={rid}: cancelled emission not an oracle prefix"
            continue
        assert not truncated and toks == oracle, \
            f"{ctx} rid={rid}: {toks} vs {oracle}"
    al = te.allocator
    if al is not None:
        assert al.n_live == 0 and al.n_reserved == 0, ctx
        assert al.n_free + al.n_cached == al.n_blocks, ctx
        assert al.n_host_live == 0, ctx
        assert al.n_host_free + al.n_host_cached == al.n_host_blocks, ctx
    got, want = te.stats(), je.stats()
    for key in ("prefix_hit_rate", "n_spec_steps", "n_spec_proposed",
                "n_spec_accepted", "n_swap_preempts", "n_swap_resumes",
                "n_spilled", "n_unspilled"):
        assert got[key] == want[key], (ctx, key)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fuzz_schedules_match_the_reference(variant):
    """``N_SCHEDULES`` seeded schedules per variant on the canonical tiny
    model."""
    for seed in range(N_SCHEDULES):
        _run_schedule(TINY, variant, seed + 17 * len(variant))


@pytest.mark.parametrize("kind,variant", [
    ("tail", "paged-prefix-tight-budget"), ("tail", "kitchen-sink"),
    ("rglru", "offload"), ("rglru", "paged"),
    ("rglru", "paged-prefix-tight-budget"), ("windowed", "paged"),
    ("rwkv", "paged-prefix-budget")])
def test_fuzz_layer_families(kind, variant):
    """The other layer families under the same schedules: the unrolled
    tail (prefix-cacheable), and hybrid stacks whose rings and recurrent
    states sit beside the block pool (the cache stays off for them, so
    their chunks take the staging path and the graft)."""
    for seed in range(N_SCHEDULES):
        _run_schedule(KIND_CFGS[kind], variant, seed + 3)
