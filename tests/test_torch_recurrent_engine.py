"""The port's engines serving the recurrent families against the JAX
engines, on the CPU: the continuous engine with the dense layout and
round mode (``InferenceEngine``), their entry points and the CLI.

Both sides get the same weights (the JAX engine's ``params``, bridged)
and the same submit/step schedule; greedy token streams must be
identical, each request finishing at the same step. Configs:
``KIND_CFGS["rglru"]``, ``KIND_CFGS["rwkv"]`` and the reduced
``recurrentgemma-2b`` (its local layers' 64-slot ring wrapped by a
100-token prompt) and ``rwkv6-3b``; token budgets force prompts through
several chunks, so recurrent state is carried across chunks and grafted
into the slot's row with every leaf.

Tolerance: token streams identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS
from repro.config import get_reduced_config
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxRoundEngine
from repro_torch.config.base import ModelConfig
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)


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


RG2B = get_reduced_config("recurrentgemma-2b")
RWKV3B = get_reduced_config("rwkv6-3b")

SCHEDULES = {
    # (config, max_slots, max_seq, token_budget, prompt lens, max_new,
    #  submit-at-step)
    "rglru-budget": (KIND_CFGS["rglru"], 2, 96, 20, (25, 6, 40), 6,
                     (0, 0, 2)),
    "rwkv-uncapped": (KIND_CFGS["rwkv"], 3, 64, None, (12, 30, 4, 19), 5,
                      (0, 1, 1, 4)),
    "recurrentgemma-2b-budget": (RG2B, 3, 160, 40, (100, 2, 60), 5,
                                 (0, 1, 1)),
    "rwkv6-3b-budget": (RWKV3B, 2, 96, 24, (40, 9, 33), 5, (0, 0, 3)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_dense_engine_token_streams_match_reference(name):
    """Same weights, same submit/step schedule, the dense layout on both
    sides: identical greedy tokens per request, finishing at the same
    step, the same decode iterations and chunk tokens."""
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
                done[tag][r.request_id] = (step, r.tokens.tolist())
        assert te.n_prefill_chunk_tokens == je.n_prefill_chunk_tokens
        step += 1
        if step > max(at) and not (je.waiting or je.active_slots):
            break
    assert len(done["jax"]) == len(prompts)
    assert done["torch"] == done["jax"]
    assert te.n_iters == je.n_iters
    # budgets below the longest prompt's bucket: chunked prefills
    assert budget is None or te.n_prefill_chunks > len(prompts)


ROUND_CFGS = {"rglru": KIND_CFGS["rglru"], "rwkv": KIND_CFGS["rwkv"],
              "recurrentgemma-2b": RG2B, "rwkv6-3b": RWKV3B}


@pytest.mark.parametrize("name", sorted(ROUND_CFGS))
def test_round_engine_token_streams_match_reference(name):
    """``generate`` on 3 left-padded prompts (one 70 tokens long, past the
    reduced recurrentgemma's 64-slot window; the recurrences run over the
    pad tokens, as in the reference): identical greedy tokens."""
    cfg = ROUND_CFGS[name]
    je = JaxRoundEngine(cfg, seed=1)
    te = InferenceEngine(_torch_cfg(cfg), device="cpu")
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 70, 7)]
    want = je.generate(prompts, max_new_tokens=8).tokens
    got = te.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.tokens.shape == (3, 8)


def test_graft_copies_every_state_leaf():
    """Grafting a one-slot staging cache writes every leaf of row
    ``slot`` (the recurrent states and the K/V ring alike) and leaves the
    other rows untouched."""
    eng = ContinuousBatchingEngine(_torch_cfg(RG2B), max_slots=3,
                                   max_seq=32, kv_layout="dense",
                                   device="cpu")
    one = eng.model.init_cache(1, 32, device="cpu")
    for layer in one:
        for t in layer.values():
            t.normal_()
    before = [{k: t.clone() for k, t in layer.items()} for layer in
              eng.cache]
    eng._graft(one, 1)
    for full, staged, old in zip(eng.cache, one, before):
        assert sorted(full) == sorted(staged)
        for key, t in full.items():
            assert torch.equal(t[1], staged[key][0])
            assert torch.equal(t[0], old[key][0])
            assert torch.equal(t[2], old[key][2])


@pytest.mark.parametrize("cfg", [RG2B, RWKV3B], ids=lambda c: c.name)
def test_paged_layout_refuses_recurrent_families(cfg):
    with pytest.raises(NotImplementedError, match="kv_layout='dense'"):
        ContinuousBatchingEngine(_torch_cfg(cfg), kv_layout="paged",
                                 device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_entry_points_serve_the_recurrent_families_on_the_cpu(arch):
    """``serve_continuous`` (dense) and ``serve_round`` at the reduced
    width, when asked for the CPU."""
    stats = engine_serve.serve_continuous(arch, duration_s=1.5, rps=20.0,
                                          token_budget=16, device="cpu")
    assert stats["served"] > 0 and stats["n_iters"] > 0
    stats = engine_serve.serve_round(arch, duration_s=1.5, rps=20.0,
                                     device="cpu")
    assert stats["served"] > 0 and stats["rounds"] > 0


def test_cli_passes_the_recurrent_archs_through(monkeypatch):
    seen = []
    monkeypatch.setattr(engine_serve, "serve_continuous",
                        lambda arch, *a, **kw: seen.append(
                            ("continuous", arch, kw["kv_layout"])))
    monkeypatch.setattr(engine_serve, "serve_round",
                        lambda arch, *a, **kw: seen.append(("round", arch)))
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        serve_cli.main(["--engine", "--arch", arch, "--device", "cpu"])
        serve_cli.main(["--engine", "--arch", arch, "--exec-mode",
                        "continuous", "--kv-layout", "dense", "--device",
                        "cpu"])
    assert seen == [("round", "recurrentgemma-2b"),
                    ("continuous", "recurrentgemma-2b", "dense"),
                    ("round", "rwkv6-3b"),
                    ("continuous", "rwkv6-3b", "dense")]
