"""Windowed and recurrent layers under the paged layout: the port against
the reference on the CPU, for each TINY layer family of
tests/conftest.py (``windowed``, ``rglru``, ``rwkv``, ``swa``) and the
reduced recurrentgemma-2b (RG-LRU layers beside MQA rings).

Under the paged layout only linear attention layers take the block pool
(``paged_layer_kind``); rings and recurrent states stay per-slot dense
beside it. Held against the reference: the layer predicate, the paged
cache's shapes, ``scatter_blocks``/``gather_blocks`` round trips, the
graft of a one-slot staging cache into blocks and rows, and greedy
serving (the reference's graft round trip against a fresh round-engine
run, and paged against dense on mixed lengths), with the engines' caches
compared after the drain.

Tolerance: tokens exact; cache tensors atol 1e-5 in fp32 where a graft
moves given values, plus rtol 1e-5 after a drain, whose states have run
through every layer several times (recurrentgemma-2b's conv state holds
values near 2, where one fp32 rounding of a matmul in another order is
about 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.config import get_reduced_config
from repro.config.base import ModelConfig as JaxModelConfig
from repro.models.transformer import gather_blocks as jax_gather
from repro.models.transformer import paged_layer_kind as jax_paged_kind
from repro.models.transformer import scatter_blocks as jax_scatter
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config.base import ModelConfig
from repro_torch.models.bridge import unstack_layers
from repro_torch.models.transformer import (gather_blocks, paged_layer_kind,
                                            scatter_blocks)
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)

CACHE_ATOL = 1e-5
DRAIN_RTOL = 1e-5

CFGS = {"windowed": KIND_CFGS["windowed"], "rglru": KIND_CFGS["rglru"],
        "rwkv": KIND_CFGS["rwkv"], "swa": KIND_CFGS["swa"],
        "recurrentgemma-2b": get_reduced_config("recurrentgemma-2b")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _caches_match(te, je, what, rtol=0.0):
    ref = unstack_layers(jax.tree.map(np.asarray, je.cache), je.cfg)
    assert len(te.cache) == len(ref)
    for i, (got, want) in enumerate(zip(te.cache, ref)):
        assert sorted(got) == sorted(want), (what, i)
        for key, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[key],
                                       atol=CACHE_ATOL, rtol=rtol,
                                       err_msg=f"{what} layer {i} {key}")


def _pair(cfg, **kw):
    je = JaxEngine(cfg, **kw)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), device="cpu", **kw)
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    return te, je


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_layer_kind_matches_the_reference(name):
    cfg = CFGS[name]
    for kind in ("attn", "attn_dense", "local_attn", "rglru", "rwkv"):
        assert paged_layer_kind(_torch_cfg(cfg), kind) \
            == jax_paged_kind(cfg, kind), kind
    assert paged_layer_kind(_torch_cfg(TINY), "attn")
    assert not paged_layer_kind(_torch_cfg(TINY), "rwkv")
    assert not paged_layer_kind(_torch_cfg(TINY), "rglru")
    swa = JaxModelConfig(name="t-swa", family="dense", n_layers=2,
                         d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                         vocab_size=97, sliding_window=32)
    assert not paged_layer_kind(_torch_cfg(swa), "attn")
    # the paged engine's cache: pools for paged layers, rows otherwise
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=3, max_seq=64,
                                  kv_layout="paged", block_size=8,
                                  kv_blocks=10, device="cpu")
    for kind, c in zip(cfg.layer_kinds(), te.cache):
        lead = 11 if jax_paged_kind(cfg, kind) else 3
        assert all(t.shape[0] == lead for t in c.values()), kind


@pytest.mark.parametrize("ids,n_rows", [([5, 2, 4], 10), ([1, 3], 8),
                                        ([0], 3)])
def test_scatter_gather_blocks_round_trip(ids, n_rows):
    """The reference's round trip on both sides: rows land in the named
    blocks (the ragged tail of the last block zero), untouched blocks
    stay zero, and the pools equal the reference's."""
    rng = np.random.default_rng(len(ids) + n_rows)
    pool = np.zeros((6, 4, 2, 3), np.float32)
    rows = rng.standard_normal((n_rows, 2, 3)).astype(np.float32)
    want = np.asarray(jax_scatter(jnp.asarray(pool), jnp.asarray(rows),
                                  jnp.asarray(ids, jnp.int32)))
    tp = torch.from_numpy(pool.copy())
    tids = torch.tensor(ids, dtype=torch.int32)
    got = scatter_blocks(tp, torch.from_numpy(rows), tids)
    assert got is tp
    np.testing.assert_allclose(got.numpy(), want, atol=CACHE_ATOL)
    back = gather_blocks(got, tids)
    np.testing.assert_array_equal(back[:n_rows].numpy(), rows)
    np.testing.assert_array_equal(back[n_rows:].numpy(), 0.0)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_gather(jnp.asarray(want),
                                            jnp.asarray(ids, jnp.int32))))
    untouched = sorted(set(range(6)) - set(ids))
    np.testing.assert_array_equal(got[untouched].numpy(), 0.0)
    with pytest.raises(ValueError):  # more rows than the blocks hold
        scatter_blocks(tp, torch.zeros(4 * len(ids) + 1, 2, 3), tids)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_graft_scatters_blocks_and_rows_like_the_reference(name):
    """A random one-slot staging cache grafted into slot 1 with the first
    of its blocks mapped shared (skipped): the paged layers' blocks and
    the dense leaves' rows equal the reference's graft of the same
    cache; the other slots' rows and blocks are untouched."""
    cfg = CFGS[name]
    te, je = _pair(cfg, max_slots=3, max_seq=48, kv_layout="paged",
                   block_size=8, kv_blocks=12)
    rng = np.random.default_rng(7)
    one = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        je.model.init_cache(1, 48, jnp.float32))
    je.cache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        je.cache)
    for t, w in zip(te.cache, unstack_layers(je.cache, cfg)):
        for key in t:
            t[key].copy_(torch.from_numpy(np.asarray(w[key])))
    ids = [7, 3, 9, 4]
    je._graft(jax.tree.map(jnp.asarray, one), 1, block_ids=ids,
              skip_blocks=1)
    staged = [{k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
              for c in unstack_layers(one, cfg)]
    te._graft(staged, 1, block_ids=ids, skip_blocks=1)
    _caches_match(te, je, name)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_graft_round_trip_matches_fresh_run(name, layout):
    """prefill -> graft -> decode through the slot engine equals a fresh
    single-sequence round-engine run, and the reference's slot engine,
    for every layer family under both layouts."""
    cfg = CFGS[name]
    kw = {"kv_layout": "paged", "block_size": 8} if layout == "paged" \
        else {"kv_layout": "dense"}
    te, je = _pair(cfg, max_slots=2, max_seq=64, **kw)
    rnd = InferenceEngine(_torch_cfg(cfg), max_seq=64, device="cpu",
                          params=te.params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 17)]
    got = [r.tokens.tolist() for r in te.run(prompts, max_new_tokens=4)]
    assert got == [r.tokens.tolist()
                   for r in je.run(prompts, max_new_tokens=4)]
    for p, toks in zip(prompts, got):
        assert toks == rnd.generate([p], max_new_tokens=4).tokens[0] \
            .tolist(), name
    _caches_match(te, je, f"{name} {layout}", rtol=DRAIN_RTOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_matches_dense_on_mixed_lengths(name):
    """Token-identical greedy outputs across layouts on a mixed-length
    prompt set that churns slots and block boundaries under a token
    budget (chunked prompts carry rings and states across chunks); the
    port's paged engine equals the reference's step for step, every
    block returns, and the caches match after the drain."""
    cfg = CFGS[name]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 14, 9, 30, 6, 22, 12, 5)]
    dense = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=3,
                                     max_seq=64, token_budget=12,
                                     device="cpu")
    te, je = _pair(cfg, max_slots=3, max_seq=64, kv_layout="paged",
                   block_size=8, token_budget=12)
    dense.load_jax_params(jax.tree.map(np.asarray, je.params))
    for p in prompts:
        assert te.submit(p, 7) == je.submit(p, 7) == dense.submit(p, 7)
    done = {"te": {}, "je": {}, "dense": {}}
    for _ in range(200):
        for tag, eng in (("te", te), ("je", je), ("dense", dense)):
            for r in eng.step():
                done[tag][r.request_id] = r.tokens.tolist()
        assert te.kv_used_tokens == je.kv_used_tokens
        assert te.kv_unique_used_tokens == je.kv_unique_used_tokens
        assert te.allocator.n_live == je.allocator.n_live
        if not (je.waiting or je.active_slots):
            break
    assert len(done["je"]) == len(prompts)
    assert done["te"] == done["je"] == done["dense"]
    al = te.allocator
    assert al.n_free == al.n_blocks and al.n_reserved == 0
    _caches_match(te, je, name, rtol=DRAIN_RTOL)
