"""The port's engines and pool on the remaining model families against
the JAX package's, on the CPU, with the reference's weights bridged in.

* Round mode (``InferenceEngine``) gives the reference's greedy tokens
  for all five reduced configs: chatglm3-6b, qwen2-vl-7b (decoding from
  F + S past its frontend span), seamless-m4t-large-v2 (encoder-decoder),
  starcoder2-15b and yi-34b.
* The continuous engine gives the reference's streams, dense and paged,
  under one submit/step schedule with a mid-drain submit: qwen2-vl by
  one-shot prefill admission, the others by chunks.
* What the reference refuses is refused with its message: seamless in
  the continuous engine and the pool, preemption and resume on a frontend
  engine, and the prefix cache and speculation on one. A pool serves a
  vision tenant beside a plain one, per request as the reference's pool
  does, with the prefix cache silently off for the vision tenant.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.config import get_reduced_config
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxRound
from repro.serving.runtime import ModelInstancePool as JaxPool
from repro_torch.config.base import ModelConfig
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine, PreemptedRequest,
                                        supports_prefix_cache,
                                        supports_speculation)
from repro_torch.serving.runtime import ModelInstancePool

FAMILIES = ("chatglm3-6b", "qwen2-vl-7b", "seamless-m4t-large-v2",
            "starcoder2-15b", "yi-34b")
#: a TINY-scale vision/M-RoPE tenant, as the reference's own tests use
VISION = dataclasses.replace(TINY, name="tiny-vl", family="vlm",
                             rope="mrope", frontend="vision",
                             frontend_tokens=8, d_model=64, n_heads=4,
                             n_kv_heads=2)
ENCDEC_MSG = "continuous batching does not support encoder-decoder"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("arch", FAMILIES)
def test_round_tokens_equal_the_references(arch):
    """One left-padded round of three prompts, six greedy tokens each."""
    cfg = get_reduced_config(arch)
    ref = JaxRound(cfg, max_seq=128, seed=0)
    eng = InferenceEngine(_torch_cfg(cfg), max_seq=128, device="cpu")
    eng.load_jax_params(jax.tree.map(np.asarray, ref.params))
    prompts = _prompts(cfg, (5, 13, 9), seed=1)
    want = ref.generate(prompts, max_new_tokens=6).tokens
    got = eng.generate(prompts, max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, want)


def _drain(eng, prompts, late, max_new):
    """Submit ``prompts``, step twice, submit ``late`` mid-drain, drain:
    request id -> tokens, and the engine's admission count."""
    for p in prompts:
        eng.submit(p, max_new)
    done = eng.step() + eng.step()
    for p in late:
        eng.submit(p, max_new)
    while eng.waiting or eng.active_slots:
        done += eng.step()
    return {r.request_id: list(r.tokens) for r in done}, eng.n_admitted


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "chatglm3-6b",
                                  "starcoder2-15b", "yi-34b"])
def test_continuous_streams_equal_the_references(arch, kv_layout):
    """Three slots, five requests (two submitted mid-drain), a token
    budget that splits the chunked families' prompts: the same stream
    per request as the reference's engine, on both layouts."""
    cfg = get_reduced_config(arch)
    kw = dict(max_slots=3, max_seq=96, kv_layout=kv_layout, token_budget=12)
    if kv_layout == "paged":
        kw["block_size"] = 8
    ref = JaxEngine(cfg, **kw)
    eng = ContinuousBatchingEngine(_torch_cfg(cfg), device="cpu", **kw)
    eng.load_jax_params(jax.tree.map(np.asarray, ref.params))
    assert eng.chunked == ref.chunked == (cfg.frontend is None)
    assert eng.fused_prefill == ref.fused_prefill
    prompts = _prompts(cfg, (5, 19, 11, 7, 30), seed=2)
    got = _drain(eng, prompts[:3], prompts[3:], 5)
    want = _drain(ref, prompts[:3], prompts[3:], 5)
    assert got == want
    assert len(got[0]) == 5
    if kv_layout == "paged":
        assert eng.allocator.n_live == ref.allocator.n_live == 0


def test_frontend_footprints_count_the_frontend_span():
    """The frontend span counts in every footprint: the paged blocks a
    request reserves, the backlog of a queued prompt, and the cache-fit
    check at submit, as in the reference."""
    kw = dict(max_slots=2, max_seq=40, kv_layout="paged", block_size=8)
    ref = JaxEngine(VISION, **kw)
    eng = ContinuousBatchingEngine(_torch_cfg(VISION), device="cpu", **kw)
    for n, new in ((3, 4), (16, 30), (9, 2)):
        assert eng.request_blocks(n, new) == ref.request_blocks(n, new)
    p = np.arange(1, 6, dtype=np.int32)
    for e in (eng, ref):
        e.submit(p, 4)
    assert eng.prefill_backlog_tokens == ref.prefill_backlog_tokens == 8 + 16
    for e in (eng, ref):  # 8 + 32 positions leave no room in 40
        with pytest.raises(ValueError, match=r"\(\+8 frontend\) does not"):
            e.submit(np.ones(20, np.int32), 4)


def test_encoder_decoder_is_refused_where_the_reference_refuses_it():
    """Seamless serves in round mode; the continuous engine (both
    layouts) and a pool tenant raise the reference's error."""
    cfg = get_reduced_config("seamless-m4t-large-v2")
    for layout in ("dense", "paged"):
        with pytest.raises(NotImplementedError, match=ENCDEC_MSG):
            JaxEngine(cfg, kv_layout=layout)
        with pytest.raises(NotImplementedError, match=ENCDEC_MSG):
            ContinuousBatchingEngine(_torch_cfg(cfg), kv_layout=layout,
                                     device="cpu")
    ref = JaxPool({cfg.name: cfg}, max_instances=1)
    pool = ModelInstancePool({cfg.name: _torch_cfg(cfg)}, max_instances=1,
                             device="cpu")
    for p in (ref, pool):
        with pytest.raises(NotImplementedError, match=ENCDEC_MSG):
            p.scale_to(cfg.name, 1)


def test_frontend_engine_refuses_preemption_and_gates():
    """A frontend engine has no chunked path: preemption, resume and its
    candidates follow the reference's refusals; the prefix cache and
    speculation raise the reference's ValueErrors."""
    tcfg = _torch_cfg(VISION)
    assert not supports_prefix_cache(tcfg) and not supports_speculation(tcfg)
    for ctor, c, kw in ((JaxEngine, VISION, {}),
                        (ContinuousBatchingEngine, tcfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="prefix_cache needs every"):
            ctor(c, kv_layout="paged", prefix_cache=True, **kw)
        with pytest.raises(ValueError, match="speculative decoding needs"):
            ctor(c, spec_k=2, **kw)
        eng = ctor(c, max_slots=2, max_seq=64, **kw)
        eng.submit(np.arange(1, 6, dtype=np.int32), 4)
        eng.step()
        assert eng.decoding_slots == [0]
        assert eng.preemption_candidates() == []
        with pytest.raises(NotImplementedError,
                           match="preemption needs the chunked"):
            eng.preempt(0)
        snap = PreemptedRequest(0, np.zeros(16, np.int32), base_len=16,
                                max_new=2, submit_s=0.0, requested_new=2,
                                truncated=False, n_preempted=1)
        with pytest.raises(NotImplementedError,
                           match="preemption-resume needs the chunked"):
            eng.submit_resume(snap)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_pool_with_a_vision_tenant_matches_the_jax_pool(kv_layout,
                                                         monkeypatch):
    """A vision tenant beside a plain TINY one, paged with the prefix
    cache on (silently off for the vision tenant): the same instance and
    tokens per request as the reference's pool, both clocks held at one
    instant."""
    cfgs = {"tiny": TINY, "tiny-vl": VISION}
    kw = dict(max_instances=3, max_slots=2, max_seq=64, seed=0,
              kv_layout=kv_layout, block_size=8,
              prefix_cache=kv_layout == "paged",
              kv_block_budget=64 if kv_layout == "paged" else None)
    ref = JaxPool(cfgs, **kw)
    port = ModelInstancePool({m: _torch_cfg(c) for m, c in cfgs.items()},
                             device="cpu", **kw)
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: 1.0)
        pool.scale_to("tiny", 1)
        pool.scale_to("tiny-vl", 2)
    for m in cfgs:
        port.load_jax_params(m, jax.tree.map(
            np.asarray, ref.running(m)[0].engine.params))
    assert [i.engine.prefix_cache for i in port.running("tiny-vl")] == \
        [i.engine.prefix_cache for i in ref.running("tiny-vl")] == \
        [False, False]
    assert port.running("tiny")[0].engine.prefix_cache == \
        ref.running("tiny")[0].engine.prefix_cache == (kv_layout == "paged")
    rng = np.random.default_rng(4)
    schedule = []
    for step in range(4):
        for _ in range(int(rng.integers(1, 4))):
            m = ("tiny", "tiny-vl")[int(rng.integers(2))]
            p = rng.integers(1, cfgs[m].vocab_size,
                             int(rng.integers(3, 14))).astype(np.int32)
            schedule.append((step, m, p, float(rng.integers(10, 90)) * 1e3,
                             int(rng.integers(2, 6))))
    out = {}
    for name, pool in (("ref", ref), ("port", port)):
        res = []
        for step in range(4):
            for s, m, p, slo, n in schedule:
                if s == step:
                    pool.submit(m, p, slo_ms=slo, max_new_tokens=n,
                                submit_s=1.0)
            res += pool.step()
        res += pool.run_until_drained()
        out[name] = ({r.request_id: (r.model, r.instance_id,
                                     list(r.tokens)) for r in res},
                     list(pool.admission_log))
    assert len(out["ref"][0]) == len(schedule)
    assert out["port"] == out["ref"]
