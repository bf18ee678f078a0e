"""Round mode of the port against the JAX package, on the CPU: the model's
one-shot prefill and dense-cache decode, ``InferenceEngine`` and the
``serve_round`` entry point.

Both sides get the same weights (the JAX engine's ``params``, bridged
through ``repro_torch.models.bridge``) and the same numpy prompts.
Configs: the tiny dense model, ``KIND_CFGS["windowed"]`` (an ``attn`` and
a ``local_attn`` layer, both with a 16-slot ring), ``KIND_CFGS["swa"]``
(every layer a ring of 8 slots, shorter than the prompts) and reduced
qwen3-0.6b (GQA, qk-norm, tied head).

Tolerance: logits atol 1e-4 (fp32 through a few layers and a vocabulary
projection, summed in another order) with identical argmax; caches atol
1e-5; token streams identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.config import get_reduced_config
from repro.models.transformer import pad_cache as jax_pad_cache
from repro.serving.engine import InferenceEngine as JaxRoundEngine
from repro.serving.engine import make_prefill_batch as jax_make_batch
from repro_torch.config.base import ModelConfig
from repro_torch.core.sac import SACAgent
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli
from repro_torch.models.bridge import unstack_layers
from repro_torch.models.transformer import pad_cache
from repro_torch.serving.engine import InferenceEngine, make_prefill_batch

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


CFGS = {"tiny": TINY, "windowed": KIND_CFGS["windowed"],
        "swa": KIND_CFGS["swa"],
        "qwen3-0.6b": get_reduced_config("qwen3-0.6b")}


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


_PAIRS = {}


def _pair(name):
    """(jax cfg, JAX round engine, port round engine on its weights); one
    JAX engine per config for the module, so its jits compile once."""
    if name not in _PAIRS:
        cfg = CFGS[name]
        je = JaxRoundEngine(cfg, seed=1)
        te = InferenceEngine(_torch_cfg(cfg), device="cpu")
        te.load_jax_params(jax.tree.map(np.asarray, je.params))
        _PAIRS[name] = (cfg, je, te)
    return _PAIRS[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _caches_equal(jcache, tcache, cfg):
    for li, (jl, tl) in enumerate(zip(unstack_layers(jcache, cfg), tcache)):
        for key in ("k", "v"):
            assert tuple(tl[key].shape) == jl[key].shape, (li, key)
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"layer {li} {key}")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_and_dense_decode_match_reference(name):
    """A left-padded batch of prompts longer than the windows: prefill
    logits and caches (linear S rows, rings of ``window`` slots holding
    the last positions), then ``pad_cache`` and three dense decode
    steps, logits and caches, all as the JAX model computes them."""
    cfg, je, te = _pair(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 9, 31)]
    batch, S, _ = make_prefill_batch(te.cfg, prompts)
    jbatch, jS, _ = jax_make_batch(cfg, prompts)
    np.testing.assert_array_equal(batch["tokens"],
                                  np.asarray(jbatch["tokens"]))
    assert S == jS == 32
    jl, jc = je._prefill(je.params, jbatch)
    tl, tc = te.model.prefill(te.params, {"tokens": _t(batch["tokens"])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    _caches_equal(jc, tc, cfg)
    # grown by the 12 slots the engine test's rounds decode, so the JAX
    # decode compiles once per config
    jc, tc = jax_pad_cache(cfg, jc, 12), pad_cache(te.cfg, tc, 12)
    _caches_equal(jc, tc, cfg)
    B = batch["tokens"].shape[0]
    pos = np.full((B,), S, np.int32)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = je._decode(je.params, jc, {"tokens": jnp.asarray(tok),
                                            "pos": jnp.asarray(pos)})
        tl, tc = te.model.decode_step(te.params, tc, {"tokens": _t(tok),
                                                      "pos": _t(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    _caches_equal(jc, tc, cfg)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_round_engine_token_streams_match_reference(name):
    """``generate`` on a batch of 3 prompts (bucketed to 4 rows, one of
    them all padding): greedy tokens identical to the JAX engine's."""
    cfg, je, te = _pair(name)
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 20, 7)]
    want = je.generate(prompts, max_new_tokens=12).tokens
    got = te.generate(prompts, max_new_tokens=12)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.tokens.shape == (3, 12)
    assert got.total_ms >= got.prefill_ms > 0 and got.decode_ms > 0


def test_make_prefill_batch_left_pads_into_buckets():
    """Rows bucket to a power of two, the length to SEQ_BUCKETS; the
    prompt ends at the last position and the padding is token 0."""
    batch, S, lens = make_prefill_batch(_torch_cfg(TINY), [
        np.arange(1, 4, dtype=np.int32), np.arange(1, 18, dtype=np.int32),
        np.ones(5, np.int32)])
    toks = batch["tokens"]
    assert toks.shape == (4, 32) and S == 32 and toks.dtype == np.int32
    assert lens.tolist() == [3, 17, 5, 0]
    assert toks[0, -3:].tolist() == [1, 2, 3] and not toks[0, :-3].any()
    assert not toks[3].any()


def test_pad_cache_grows_linear_layers_only():
    """A linear layer gains ``extra`` zero slots after its rows; a ring
    buffer passes through untouched."""
    cfg = dataclasses.replace(_torch_cfg(TINY),
                              block_pattern=("attn", "local_attn"))
    cache = [{key: torch.randn(2, 5, 2, 16) for key in ("k", "v")}
             for _ in range(2)]
    grown = pad_cache(cfg, cache, 3)
    for key in ("k", "v"):
        assert grown[0][key].shape == (2, 8, 2, 16)
        assert torch.equal(grown[0][key][:, :5], cache[0][key])
        assert not grown[0][key][:, 5:].any()
    assert grown[1] is cache[1]


def test_generate_refuses_sampling():
    _, _, te = _pair("tiny")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        te.generate([np.ones(3, np.int32)], max_new_tokens=2, greedy=False)


def test_round_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """No GPU and no ``device`` argument: the round engine, the SAC
    agent, serve_round and the CLI's default (round) mode raise instead
    of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _torch_cfg(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SACAgent(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_serve.serve_round(cfg=cfg, duration_s=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--engine"])


def test_serve_round_serves_on_the_cpu_when_asked():
    """The round entry point: requests are served, and the SAC agent acts
    every round and updates once its replay holds a mini-batch."""
    stats = engine_serve.serve_round(cfg=_torch_cfg(TINY), duration_s=3.0,
                                     rps=100.0, device="cpu")
    assert stats["served"] > 0 and stats["rounds"] >= 33
    assert stats["sac_updates"] == stats["rounds"] - 31
    assert stats["sac_act_ms"] > 0 and stats["sac_update_ms"] > 0
