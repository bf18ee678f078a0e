"""The port's continuous engine with the dense KV layout against the JAX
engine, on the CPU, plus the dense layout's write bounds.

Both engines get the same weights (the JAX engine's ``params``, bridged)
and the same submit/step schedule; their greedy token streams must be
identical, each request finishing at the same step. Configs:
``KIND_CFGS["windowed"]`` and ``KIND_CFGS["swa"]`` (ring buffers of 16
and 8 slots, chunks larger than the window) and reduced qwen3-0.6b (the
global layer kind; tests/test_torch_round.py holds the tiny model).

Tolerance: token streams identical; chunked-prefill logits atol 1e-4 and
caches atol 1e-5 against one single chunk.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.config import get_reduced_config
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config.base import ModelConfig
from repro_torch.launch import engine_serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ContinuousBatchingEngine

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


SCHEDULES = {
    # (config, max_slots, max_seq, token_budget, prompt lens, max_new,
    #  submit-at-step)
    "windowed-budget": (KIND_CFGS["windowed"], 2, 96, 20, (25, 6, 40), 6,
                        (0, 0, 2)),
    "swa-uncapped": (KIND_CFGS["swa"], 3, 64, None, (12, 30, 4, 19), 7,
                     (0, 1, 1, 4)),
    "qwen3-budget": (get_reduced_config("qwen3-0.6b"), 3, 96, 20,
                     (40, 2, 60, 15), 6, (0, 1, 1, 4)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_dense_engine_token_streams_match_reference(name):
    """Same weights, same submit/step schedule, the dense layout on both
    sides: identical greedy tokens per request, finishing at the same
    step, the same number of decode iterations and chunk tokens."""
    cfg, slots, max_seq, budget, lens, max_new, at = SCHEDULES[name]
    je = JaxEngine(cfg, max_slots=slots, max_seq=max_seq, kv_layout="dense",
                   token_budget=budget)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=slots,
                                  max_seq=max_seq, kv_layout="dense",
                                  token_budget=budget, device="cpu")
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    done = {"jax": {}, "torch": {}}
    step = 0
    while step < 200:
        for p, t in zip(prompts, at):
            if t == step:
                assert je.submit(p, max_new) == te.submit(p, max_new)
        for tag, eng in (("jax", je), ("torch", te)):
            for r in eng.step():
                done[tag][r.request_id] = (step, r.tokens.tolist(),
                                           r.truncated)
        assert te.n_prefill_chunk_tokens == je.n_prefill_chunk_tokens
        assert te.kv_used_tokens == je.kv_used_tokens
        step += 1
        if step > max(at) and not (je.waiting or je.active_slots):
            break
    assert len(done["jax"]) == len(prompts)
    assert done["torch"] == done["jax"]
    assert not (te.waiting or te.active_slots)
    assert te.n_iters == je.n_iters
    stats = te.stats()
    assert stats["kv_allocated_tokens"] == slots * max_seq
    assert stats["kv_reserved_tokens"] == 0


@pytest.mark.parametrize("name", ["swa", "windowed", "global"])
def test_dense_chunked_prefill_equals_single_chunk(name):
    """A prompt prefilled into a dense cache in pieces of 16 + 8 + 4 + 2
    (chunks larger than the 8-slot ring included, so ring slots keep the
    LAST chunk position mapping to them) leaves the same last logits and
    the same cache as one chunk."""
    cfg = _torch_cfg(KIND_CFGS[name])
    model = build_model(cfg)
    params = init_params(cfg, seed=2, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 30))
    toks = torch.from_numpy(toks.astype(np.int32))
    one = model.init_cache(1, 48, device="cpu")
    want, one = model.prefill_chunk(params, one, {
        "tokens": toks, "pos": torch.zeros(1, dtype=torch.int32)})
    many = model.init_cache(1, 48, device="cpu")
    p = 0
    for c in (16, 8, 4, 2):
        got, many = model.prefill_chunk(params, many, {
            "tokens": toks[:, p:p + c],
            "pos": torch.tensor([p], dtype=torch.int32)})
        p += c
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    for a, b in zip(one, many):
        for key in ("k", "v"):
            torch.testing.assert_close(a[key], b[key], atol=CACHE_ATOL,
                                       rtol=0)
    # the one-shot prefill's ring keeps the same positions in the same
    # slots as the chunked writes
    _, full = model.prefill(params, {"tokens": toks})
    for a, f in zip(many, full):
        if a["k"].shape[1] == f["k"].shape[1] < toks.shape[1]:
            torch.testing.assert_close(a["k"], f["k"], atol=CACHE_ATOL,
                                       rtol=0)


def test_dense_writes_refuse_rows_past_the_cache():
    """Explicit bounds: a linear write at a slot >= C raises (the
    reference's dynamic_update_slice would clamp the start and overwrite
    earlier rows); a row in range lands exactly there."""
    cache = torch.zeros(2, 6, 1, 4)
    row = torch.ones(2, 1, 1, 4)
    tattn._write_cache(cache, row, torch.tensor([5, 0], dtype=torch.int32))
    assert cache[0, 5].eq(1).all() and cache[1, 0].eq(1).all()
    assert cache.sum() == 8
    with pytest.raises(IndexError):
        tattn._write_cache(cache, 2 * row,
                           torch.tensor([6, 0], dtype=torch.int32))
    chunk = torch.full((2, 3, 1, 4), 3.0)
    with pytest.raises(IndexError):  # rows 4, 5, 6 of sequence 0
        tattn._write_chunk_linear(cache, chunk,
                                  torch.tensor([4, 0], dtype=torch.int32))
    tattn._write_chunk_linear(cache, chunk,
                              torch.tensor([3, 0], dtype=torch.int32))
    assert cache[0, 3:].eq(3).all() and cache[1, :3].eq(3).all()
    assert cache[0, :3].eq(0).all()


def test_ring_write_keeps_the_last_position_per_slot():
    """A chunk longer than the ring: slot (pos + j) % C holds chunk row j
    for the largest such j, and slots the chunk misses keep their value
    (the reference's ``_write_chunk_ring``)."""
    C, T = 4, 7
    cache = torch.full((1, C, 1, 1), -1.0)
    new = torch.arange(T, dtype=torch.float32).reshape(1, T, 1, 1)
    tattn._write_chunk_ring(cache, new, torch.tensor([2], dtype=torch.int32))
    # positions 2..8 -> slots 2,3,0,1,2,3,0: last rows 6,3,4,5 at 0..3
    assert cache.flatten().tolist() == [6.0, 3.0, 4.0, 5.0]
    short = torch.full((1, C, 1, 1), -1.0)
    tattn._write_chunk_ring(short, new[:, :2],
                            torch.tensor([3], dtype=torch.int32))
    assert short.flatten().tolist() == [1.0, -1.0, -1.0, 0.0]


def test_paged_engine_still_refuses_windowed_stacks():
    """Windowed layers keep their dense rings beside the pool under the
    paged layout, as in the reference: the paged engine serves the
    reference's paged tokens, its rings equal the reference's to 1e-5,
    and what it still refuses is the prefix cache (the reference's
    ValueError: a ring cannot be shared)."""
    from repro_torch.models.bridge import unstack_layers

    for name in ("windowed", "swa"):
        cfg = KIND_CFGS[name]
        with pytest.raises(ValueError, match="prefix_cache"):
            ContinuousBatchingEngine(_torch_cfg(cfg), kv_layout="paged",
                                     prefix_cache=True, device="cpu")
        kw = dict(max_slots=2, max_seq=96, kv_layout="paged", block_size=8,
                  token_budget=12)
        je = JaxEngine(cfg, **kw)
        te = ContinuousBatchingEngine(_torch_cfg(cfg), device="cpu", **kw)
        te.load_jax_params(jax.tree.map(np.asarray, je.params))
        rng = np.random.default_rng(len(name))
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (25, 6, 40)]
        want = [r.tokens.tolist() for r in je.run(prompts, 6)]
        assert [r.tokens.tolist() for r in te.run(prompts, 6)] == want
        ref = unstack_layers(jax.tree.map(np.asarray, je.cache), cfg)
        for got, exp in zip(te.cache, ref):
            for key, t in got.items():
                np.testing.assert_allclose(t.numpy(), exp[key],
                                           atol=CACHE_ATOL, err_msg=name)


def test_serve_continuous_dense_serves_on_the_cpu_when_asked():
    stats = engine_serve.serve_continuous(cfg=_torch_cfg(TINY),
                                          duration_s=2.0, rps=30.0,
                                          token_budget=16, device="cpu")
    assert stats["served"] > 0 and stats["n_iters"] > 0
    assert stats["kv_allocated_tokens"] == 4 * 128
