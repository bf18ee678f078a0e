"""The port's speculative decoding against the reference's, on the CPU:
the tests of tests/test_speculative.py, each run on the reference engine
and on the port's with the reference's weights bridged in, under the same
submit/step schedule, plus the verify forward and its kernel shape.

Compared: greedy streams (the port's speculative streams equal both its
own k = 0 streams and the reference's speculative ones), the speculation
counters, the allocators' whole state after rollback, and the proposers'
drafts. ``Model.verify_step``'s logits are held against the reference's at
every position, and ``paged_prefill_attention``'s plain version against
the Pallas kernel (interpret mode) and the jnp oracle at the verify shape:
B sequences, W = 1 + k rows each at their own ``pos``, tables widened by
null columns. Tolerance: tokens, counters and allocator state exact;
logits and attention outputs atol = rtol = 1e-5 in fp32 (the sums run in
another order, nothing else differs). The rollback properties run fewer
examples than the reference's (6, 5 and 4 against 20, 15 and 10): each
example drives both engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import KIND_CFGS, TINY, tiny_variant
from repro.kernels import ops, ref
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import DraftModelProposer as JaxDraft
from repro.serving.engine import NGramProposer as JaxNGram
from repro.serving.engine import sample_tokens as jax_sample_tokens
from repro.serving.engine import \
    supports_speculation as jax_supports_speculation
from repro_torch.config.base import ModelConfig
from repro_torch.kernels import prefill_attention as tpre
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        DraftModelProposer, NGramProposer,
                                        sample_tokens, supports_speculation)

MAX_SEQ = 128
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


TTINY = _torch_cfg(TINY)
_DONOR = {}


def _donor():
    """One reference engine and one port engine on its bridged weights,
    the weight donors of every engine in this module."""
    if not _DONOR:
        je = JaxEngine(TINY, max_slots=1, max_seq=MAX_SEQ, seed=0)
        te = ContinuousBatchingEngine(TTINY, max_slots=1, max_seq=MAX_SEQ,
                                      device="cpu")
        te.load_jax_params(jax.tree.map(np.asarray, je.params))
        _DONOR["pair"] = (je, te)
    return _DONOR["pair"]


def _engines(max_slots=3, ref_kw=None, port_kw=None, **kw):
    """(reference engine, port engine) on the donor's weights."""
    jd, td = _donor()
    je = JaxEngine(TINY, max_slots=max_slots, max_seq=MAX_SEQ, seed=0,
                   share_from=jd, **kw, **(ref_kw or {}))
    te = ContinuousBatchingEngine(TTINY, max_slots=max_slots,
                                  max_seq=MAX_SEQ, device="cpu",
                                  share_from=td, **kw, **(port_kw or {}))
    return je, te


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY.vocab_size, int(L)).astype(np.int32)
            for L in rng.integers(4, 28, n)]


def _alloc_state(al):
    return (list(al._free), sorted(al._outstanding), dict(al._refcount),
            dict(al._cache), list(al._lru), al.n_reserved, al.n_reclaimed)


def _spec_counts(eng):
    return (eng.n_spec_steps, eng.n_spec_proposed, eng.n_spec_accepted)


def _same_state(je, te):
    for a, b in zip(te.slots, je.slots):
        assert (a.request_id, a.blocks, a.n_outstanding, a.remaining,
                a.tokens) == (b.request_id, b.blocks, b.n_outstanding,
                              b.remaining, b.tokens)
    np.testing.assert_array_equal(te.pos, je.pos)
    np.testing.assert_array_equal(te.pending_tok, je.pending_tok)
    if te.allocator is not None:
        assert _alloc_state(te.allocator) == _alloc_state(je.allocator)
        np.testing.assert_array_equal(te.block_tables, je.block_tables)


# ---- sample_tokens ------------------------------------------------------
def test_sample_tokens_greedy_is_argmax():
    """(V,), (B,V) and the verify forward's (B,W,V): the argmax, as the
    reference's."""
    rng = np.random.default_rng(0)
    for shape in [(7,), (3, 7), (2, 4, 7)]:
        logits = rng.normal(size=shape).astype(np.float32)
        out = sample_tokens(torch.from_numpy(logits))
        assert out.shape == shape[:-1] and out.dtype == np.int32
        np.testing.assert_array_equal(out, np.argmax(logits, -1))
        np.testing.assert_array_equal(out, jax_sample_tokens(logits))


def test_sample_tokens_seeded_draw():
    logits = torch.zeros((4, 11))
    logits[:, 3] = 50.0  # near-delta: the draw must pick it
    np.testing.assert_array_equal(
        sample_tokens(logits, greedy=False, seed=1), [3, 3, 3, 3])
    flat = torch.zeros((64,))
    a = sample_tokens(flat, greedy=False, seed=1)
    assert a == sample_tokens(flat, greedy=False, seed=1)
    draws = {int(sample_tokens(flat, greedy=False, seed=s))
             for s in range(16)}
    assert len(draws) > 1


# ---- proposers ----------------------------------------------------------
def test_ngram_proposer_prompt_lookup():
    prop, jprop = NGramProposer(n=2), JaxNGram(n=2)
    ctx = np.array([7, 8, 9, 1, 2, 5, 7, 8], np.int32)
    np.testing.assert_array_equal(prop.propose(ctx, 3), [9, 1, 2])
    ctx = np.array([3, 4, 9, 3, 4, 6, 3, 4], np.int32)
    np.testing.assert_array_equal(prop.propose(ctx, 2), [6, 3])
    rng = np.random.default_rng(1)
    for _ in range(200):
        ctx = rng.integers(1, 6, int(rng.integers(1, 30))).astype(np.int32)
        k = int(rng.integers(1, 6))
        n = int(rng.integers(1, 4))
        np.testing.assert_array_equal(NGramProposer(n).propose(ctx, k),
                                      JaxNGram(n).propose(ctx, k))
    assert jprop.n == prop.n


def test_ngram_proposer_fallbacks():
    prop = NGramProposer(n=2)
    ctx = np.arange(1, 9, dtype=np.int32)
    np.testing.assert_array_equal(prop.propose(ctx, 3), [8, 8, 8])
    ctx = np.array([5, 1, 2, 5], np.int32)
    np.testing.assert_array_equal(prop.propose(ctx, 2), [1, 2])
    ctx = np.array([1, 2, 3, 1, 2], np.int32)
    got = prop.propose(ctx, 5)
    assert len(got) == 5 and got[0] == 3
    np.testing.assert_array_equal(got, JaxNGram(n=2).propose(ctx, 5))
    np.testing.assert_array_equal(prop.propose(np.zeros(0, np.int32), 2),
                                  JaxNGram(n=2).propose(
                                      np.zeros(0, np.int32), 2))


def _drafts():
    """(reference draft, port draft on its weights)."""
    jd = JaxDraft(TINY, seed=0)
    td = DraftModelProposer(TTINY, device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jd.engine.params), TTINY))
    return jd, td


def test_draft_model_proposer():
    """The draft with the reference's seed-0 weights bridged in proposes
    the reference's drafts; with the target's own weights it proposes the
    target's continuation."""
    jd, td = _drafts()
    ctx = _prompts(1)[0]
    got = td.propose(ctx, 3)
    assert got.shape == (3,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jd.propose(ctx, 3))
    np.testing.assert_array_equal(td.propose(np.zeros(0, np.int32), 2),
                                  [0, 0])
    _, eng = _engines(max_slots=1)
    np.testing.assert_array_equal(
        td.propose(ctx, 3), eng.run([ctx], max_new_tokens=3)[0].tokens)


# ---- gating -------------------------------------------------------------
def test_speculation_gated_to_rewindable_stacks():
    for kind, cfg in KIND_CFGS.items():
        assert supports_speculation(_torch_cfg(cfg)) \
            == jax_supports_speculation(cfg) == (kind in ("global", "tail"))
    with pytest.raises(ValueError, match="rewind"):
        ContinuousBatchingEngine(_torch_cfg(KIND_CFGS["rglru"]), spec_k=2,
                                 device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingEngine(_torch_cfg(tiny_variant(name="tiny-negk")),
                                 spec_k=-1, device="cpu")


# ---- the verify forward and its kernel shape ----------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_step_logits_match_the_reference(layout):
    """Four slots mid-decode at their own positions: the port's verify
    forward gives the reference's logits at all W = 5 rows and leaves the
    same cache rows."""
    from repro_torch.models.bridge import unstack_layers

    kw = {} if layout == "dense" else {"kv_layout": "paged",
                                       "block_size": 8}
    je, te = _engines(max_slots=4, spec_k=4, **kw)
    for eng in (je, te):
        for p in _prompts(4, seed=2):
            eng.submit(p, max_new_tokens=20)
        for _ in range(4):
            eng.step()
        eng.spec_k = 0
    _same_state(je, te)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, TINY.vocab_size, (4, 5)).astype(np.int32)
    batch = {"tokens": toks, "pos": je.pos.copy()}
    if layout == "paged":
        vt = np.zeros((4, je.blocks_per_slot + 1), np.int32)
        vt[:, :je.blocks_per_slot] = je.block_tables
        batch["block_tables"] = vt
    want, jcache = je._verify(je.params, je.cache,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    got, tcache = te.model.verify_step(
        te.params, te.cache, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert got.shape == (4, 5, TINY.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(tcache, unstack_layers(
            jax.tree.map(np.asarray, jcache), TINY)):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), w[key], atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.parametrize("seed,G", [(0, 2), (1, 5), (2, 7)])
def test_prefill_plain_at_the_verify_shape(seed, G):
    """B = 8 sequences of W = 5 rows, each at its own ``pos`` (one near
    the table's end, so its last rows fall in the null columns), over
    shuffled tables widened by null columns: plain == Pallas (interpret)
    == ref, every row."""
    rng = np.random.default_rng(200 + seed)
    B, W, KV, hd, bs, nb, pad = 8, 5, 2, 16, 8, 6, 1
    H = G * KV
    n_pool = 1 + B * nb
    k = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    tables = np.zeros((B, nb + pad), np.int32)
    tables[:, :nb] = rng.permutation(np.arange(1, n_pool)).reshape(B, nb)
    pos = rng.integers(0, nb * bs - W, B).astype(np.int32)
    pos[0] = nb * bs - 2  # rows 2.. lie past the last real block
    pos[1] = 0
    q = rng.standard_normal((B, W, H, hd)).astype(np.float32)
    scale = hd ** -0.5
    t = [torch.from_numpy(a) for a in (q, k, v, tables, pos)]
    got = tpre.paged_prefill_attention(*t, scale).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, tables, pos)]
    np.testing.assert_allclose(
        got, np.asarray(ops.paged_prefill_attention(*j, scale)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.paged_prefill_attention_ref(*j, scale)),
        atol=ATOL, rtol=RTOL)


# ---- differential token identity ---------------------------------------
@pytest.mark.parametrize("kw", [
    {},
    {"kv_layout": "paged", "block_size": 8},
    {"kv_layout": "paged", "block_size": 8, "prefix_cache": True},
    {"kv_layout": "paged", "block_size": 8, "kv_blocks": 20},
], ids=["dense", "paged", "prefix", "tight"])
@pytest.mark.parametrize("k", [2, 4])
def test_speculative_token_identity(kw, k):
    """The port's speculative streams equal its k = 0 streams and the
    reference's speculative ones, with the same speculation counters and,
    after the drain, the same allocator state."""
    prompts = _prompts(4)
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=10)
    je, te = _engines(spec_k=k, **kw)
    want = je.run(prompts, max_new_tokens=10)
    out = te.run(prompts, max_new_tokens=10)
    for r0, r, w in zip(base, out, want):
        assert r0.request_id == r.request_id == w.request_id
        np.testing.assert_array_equal(r0.tokens, r.tokens)
        np.testing.assert_array_equal(w.tokens, r.tokens)
        assert (r.n_spec_proposed, r.n_spec_accepted) == \
            (w.n_spec_proposed, w.n_spec_accepted)
    assert te.n_spec_steps > 0
    assert _spec_counts(te) == _spec_counts(je)
    assert te.n_spec_proposed >= te.n_spec_accepted >= 0
    assert 0.0 <= te.spec_accept_rate <= 1.0
    al = te.allocator
    if al is not None:
        assert _alloc_state(al) == _alloc_state(je.allocator)
        assert al.n_live == 0 and al.n_reserved == 0
        assert al.n_free + al.n_cached == al.n_blocks


def test_spec_k_live_toggle_token_identity():
    """Retuning the depth mid-drain (the scheduler's knob) changes no
    token, and both engines agree at every step."""
    prompts = _prompts(4, seed=3)
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=12)
    je, te = _engines(spec_k=4, kv_layout="paged", block_size=8)
    for p in prompts:
        je.submit(p, max_new_tokens=12)
        te.submit(p, max_new_tokens=12)
    out, i = {}, 0
    while je.waiting or je.active_slots:
        je.spec_k = te.spec_k = (0, 2, 4, 1)[i % 4]
        i += 1
        want = {r.request_id: r.tokens.tolist() for r in je.step()}
        got = {r.request_id: r.tokens.tolist() for r in te.step()}
        assert got == want
        _same_state(je, te)
        out.update(got)
    for r0 in base:
        assert r0.tokens.tolist() == out[r0.request_id]


def test_stats_report_speculation():
    je, te = _engines(spec_k=2)
    for eng in (je, te):
        eng.run(_prompts(2), max_new_tokens=6)
    s, w = te.stats(), je.stats()
    assert s["spec_k"] == 2.0 and s["n_spec_steps"] > 0
    assert s["n_spec_proposed"] >= s["n_spec_accepted"]
    assert 0.0 <= s["spec_accept_rate"] <= 1.0
    keys = ("spec_k", "spec_accept_rate", "n_spec_proposed",
            "n_spec_accepted", "n_spec_steps")
    assert {x: s[x] for x in keys} == {x: w[x] for x in keys}
    assert set(w) - set(s) == set()
    assert s["tp_degree"] == w["tp_degree"] == 1.0


def test_effective_spec_k_budget_degradation():
    """k shrinks so that n_dec * (1 + k) fits the token budget, as the
    reference's, and a budget-capped run still matches the uncapped
    baseline."""
    je, te = _engines(spec_k=4, token_budget=6)
    for n_dec, k in ((1, 4), (2, 2), (3, 1), (6, 0)):
        assert te._effective_spec_k(n_dec=n_dec, budget=6) == k \
            == je._effective_spec_k(n_dec=n_dec, budget=6)
    prompts = _prompts(3, seed=5)
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=8)
    want = je.run(prompts, max_new_tokens=8)
    for r0, r, w in zip(base, te.run(prompts, max_new_tokens=8), want):
        np.testing.assert_array_equal(r0.tokens, r.tokens)
        np.testing.assert_array_equal(w.tokens, r.tokens)
    assert _spec_counts(te) == _spec_counts(je)


# ---- rollback (hypothesis or the seeded stub) ---------------------------
def _decode_until(engines, min_tokens, slot_pred=None, guard=200):
    """Step both engines until some decoding slot has ``min_tokens``
    emitted (and satisfies ``slot_pred`` on the port); return that slot,
    or None when the engines drained first."""
    je, te = engines
    while guard:
        for i in te.decoding_slots:
            if len(te.slots[i].tokens) >= min_tokens and \
                    (slot_pred is None or slot_pred(i)):
                return i
        if not (te.waiting or te.active_slots):
            return None
        je.step()
        te.step()
        guard -= 1
    return None


def _drain(je, te, guard=400):
    out = {}
    while (te.waiting or te.active_slots) and guard:
        want = {r.request_id: r.tokens.tolist() for r in je.step()}
        got = {r.request_id: r.tokens.tolist() for r in te.step()}
        assert got == want
        out.update(got)
        guard -= 1
    assert guard, "engine failed to drain"
    return out


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n=st.integers(min_value=1, max_value=6),
       steps=st.integers(min_value=1, max_value=8))
def test_rollback_then_redecode_token_identical(seed, n, steps):
    """rollback(n) at an arbitrary decode point, then draining, gives the
    uninterrupted greedy output, on both engines, with the same state."""
    prompts = _prompts(3, seed=seed % 7)
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=10)
    je, te = _engines(kv_layout="paged", block_size=8)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
        for _ in range(steps):
            eng.step()
    slot = _decode_until((je, te), min_tokens=1)
    if slot is not None:
        m = min(n, len(te.slots[slot].tokens))
        je.rollback(slot, m)
        te.rollback(slot, m)
        _same_state(je, te)
    out = _drain(je, te)
    for r0 in base:
        assert r0.tokens.tolist() == out[r0.request_id]


@settings(max_examples=5, deadline=None)
@given(n=st.integers(min_value=1, max_value=8))
def test_rollback_conserves_allocator(n):
    """Every freed block returns and the reservation is restored (the
    reference's allocator state, exactly), so the slot decodes to the end
    without a mid-sequence shortage."""
    je, te = _engines(kv_layout="paged", block_size=8)
    for eng in (je, te):
        for p in _prompts(3, seed=11):
            eng.submit(p, max_new_tokens=10)
    slot = _decode_until((je, te), min_tokens=3)
    assert slot is not None
    s = te.slots[slot]
    m = min(n, len(s.tokens))
    je.rollback(slot, m)
    te.rollback(slot, m)
    _same_state(je, te)
    al = te.allocator
    assert al.n_free + al.n_cached + al.n_live == al.n_blocks
    assert al.n_available >= 0
    nb = len(s.blocks)
    np.testing.assert_array_equal(te.block_tables[slot, :nb], s.blocks)
    assert not te.block_tables[slot, nb:].any()
    assert nb == al.blocks_for(int(te.pos[slot]))
    _drain(je, te)
    assert al.n_live == 0 and al.n_reserved == 0
    assert al.n_free + al.n_cached == al.n_blocks


@settings(max_examples=4, deadline=None)
@given(n=st.integers(min_value=1, max_value=6))
def test_rollback_never_frees_shared_prefix_blocks(n):
    """Two residents share registered prefix blocks at refcount 2:
    rolling one back trims only its own decode tail; the shared blocks
    keep their refcount and the sibling's output is untouched."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, TINY.vocab_size, 24).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        1, TINY.vocab_size, 4).astype(np.int32)]) for _ in range(2)]
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=10)
    je, te = _engines(kv_layout="paged", block_size=8, prefix_cache=True)
    for eng in (je, te):
        eng.run([prompts[0]], max_new_tokens=2)
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
    al = te.allocator
    slot = _decode_until(
        (je, te), min_tokens=1,
        slot_pred=lambda i: any(al.refcount(b) > 1
                                for b in te.slots[i].blocks))
    assert slot is not None, "no slot with shared blocks reached decode"
    s = te.slots[slot]
    shared_before = {b: al.refcount(b) for b in s.blocks
                     if al.refcount(b) > 1}
    assert shared_before
    m = min(n, len(s.tokens))
    je.rollback(slot, m)
    te.rollback(slot, m)
    _same_state(je, te)
    for b, rc in shared_before.items():
        assert b in s.blocks and al.refcount(b) == rc
    out = _drain(je, te)
    for r0, rid in zip(base, sorted(out)[-2:]):
        assert r0.tokens.tolist() == out[rid]


def test_rollback_rejects_bad_calls():
    for eng in _engines():
        with pytest.raises(ValueError, match="not decoding"):
            eng.rollback(0, 1)
        eng.submit(_prompts(1)[0], max_new_tokens=6)
        while not eng.decoding_slots:
            eng.step()
        slot = eng.decoding_slots[0]
        while not eng.slots[slot].tokens:
            eng.step()
        with pytest.raises(ValueError, match="roll back"):
            eng.rollback(slot, len(eng.slots[slot].tokens) + 1)
        with pytest.raises(ValueError, match="roll back"):
            eng.rollback(slot, 0)
    rec = ContinuousBatchingEngine(_torch_cfg(KIND_CFGS["rglru"]),
                                   max_slots=2, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="rewind"):
        rec.rollback(0, 1)


# ---- draft-model proposal end to end ------------------------------------
def test_draft_proposer_engine_token_identity():
    """The engines with the reference's draft and its bridged port: the
    reference's tokens and acceptance, which is above 0 (the draft has
    the target's weights)."""
    prompts = _prompts(3, seed=9)
    _, base_eng = _engines()
    base = base_eng.run(prompts, max_new_tokens=8)
    jd, td = _drafts()
    je, te = _engines(spec_k=3, kv_layout="paged", block_size=8,
                      ref_kw={"proposer": jd}, port_kw={"proposer": td})
    want = je.run(prompts, max_new_tokens=8)
    for r0, r, w in zip(base, te.run(prompts, max_new_tokens=8), want):
        np.testing.assert_array_equal(r0.tokens, r.tokens)
        np.testing.assert_array_equal(w.tokens, r.tokens)
    assert _spec_counts(te) == _spec_counts(je)
    assert te.n_spec_steps > 0
    assert te.spec_accept_rate > 0.0, te.spec_accept_rate
