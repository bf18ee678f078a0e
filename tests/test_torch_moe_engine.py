"""The port's engines serving the MoE family against the JAX engines, on
the CPU: the continuous engine with the paged and the dense layout, round
mode (``InferenceEngine``), their entry points and the CLI.

Both sides get the same weights (the JAX engine's ``params``, bridged)
and the same submit/step schedule; greedy token streams must be
identical, each request finishing at the same step. An MoE layer's
capacity follows the rows of each forward (decode: every slot, idle
ones' dummy tokens included; a chunk: its unpadded tokens; a round: the
left-padded ``(B, S)`` batch), so the streams match only if the port
batches as the reference does. Configs: reduced ``arctic-480b`` (top-2,
dense residual) and ``llama4-maverick-400b-a17b`` (``attn_dense`` then
top-1 MoE); one chunked schedule and one round run at capacity factor
1.0, where entries are dropped (checked on the port's side).

Tolerance: token streams identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import get_reduced_config
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import InferenceEngine as JaxRoundEngine
from repro_torch.config.base import ModelConfig
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)

ARCTIC = get_reduced_config("arctic-480b")
LLAMA4 = get_reduced_config("llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cf(cfg, cf):
    if cf == cfg.capacity_factor:
        return cfg
    return dataclasses.replace(cfg, name=f"{cfg.name}-cf{cf}",
                               capacity_factor=cf)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture()
def drops(monkeypatch):
    """Every ``drop_frac`` the port's MoE layers report."""
    seen = []
    orig = tmoe.moe_apply

    def watched(p, x, cfg):
        y, aux = orig(p, x, cfg)
        seen.append(float(aux["drop_frac"]))
        return y, aux
    monkeypatch.setattr(tmoe, "moe_apply", watched)
    return seen


SCHEDULES = {
    # (config, capacity factor, layout, max_slots, max_seq, token_budget,
    #  prompt lens, max_new, submit-at-step)
    "arctic-paged": (ARCTIC, 8.0, "paged", 3, 96, 20, (25, 6, 40), 5,
                     (0, 0, 2)),
    "arctic-dense-cf1": (ARCTIC, 1.0, "dense", 2, 96, 32, (40, 9, 33), 5,
                         (0, 1, 1)),
    "llama4-paged-cf1": (LLAMA4, 1.0, "paged", 3, 96, 24, (33, 17, 4), 5,
                         (0, 0, 3)),
    "llama4-dense": (LLAMA4, 8.0, "dense", 3, 64, None, (12, 30, 4, 19), 4,
                     (0, 1, 1, 4)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_continuous_engine_token_streams_match_reference(name, drops):
    """Same weights, same submit/step schedule, the same layout on both
    sides: identical greedy tokens per request, finishing at the same
    step, the same decode iterations and chunk tokens; token budgets
    below the prompts force chunked prefills, and at capacity factor 1.0
    the 16- and 32-token chunks drop entries."""
    cfg, cf, layout, slots, max_seq, budget, lens, max_new, at = \
        SCHEDULES[name]
    cfg = _cf(cfg, cf)
    je = JaxEngine(cfg, max_slots=slots, max_seq=max_seq, kv_layout=layout,
                   token_budget=budget)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=slots,
                                  max_seq=max_seq, kv_layout=layout,
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
    assert budget is None or te.n_prefill_chunks > len(prompts)
    assert (max(drops) > 0) == (cf == 1.0)


@pytest.mark.parametrize("cfg,cf", [(ARCTIC, 8.0), (LLAMA4, 1.0)],
                         ids=["arctic", "llama4-cf1"])
def test_round_engine_token_streams_match_reference(cfg, cf, drops):
    """``generate`` on 3 left-padded prompts (batch bucket 4, sequence
    bucket 128: the pad rows route through the experts and take capacity,
    as in the reference): identical greedy tokens."""
    cfg = _cf(cfg, cf)
    je = JaxRoundEngine(cfg, seed=1)
    te = InferenceEngine(_torch_cfg(cfg), device="cpu")
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    rng = np.random.default_rng(int(cf * 10))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 70, 7)]
    want = je.generate(prompts, max_new_tokens=6).tokens
    got = te.generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.tokens.shape == (3, 6)
    assert (max(drops) > 0) == (cf == 1.0)


@pytest.mark.parametrize("arch", ["arctic-480b",
                                  "llama4-maverick-400b-a17b"])
def test_entry_points_serve_the_moe_family_on_the_cpu(arch):
    """``serve_continuous`` under both layouts and ``serve_round`` at the
    reduced width, when asked for the CPU."""
    for layout in ("paged", "dense"):
        stats = engine_serve.serve_continuous(
            arch, duration_s=1.0, rps=20.0, token_budget=16,
            kv_layout=layout, device="cpu")
        assert stats["served"] > 0 and stats["n_iters"] > 0
    stats = engine_serve.serve_round(arch, duration_s=1.0, rps=20.0,
                                     device="cpu")
    assert stats["served"] > 0 and stats["rounds"] > 0


def test_cli_passes_the_moe_archs_through(monkeypatch):
    seen = []
    monkeypatch.setattr(engine_serve, "serve_continuous",
                        lambda arch, *a, **kw: seen.append(
                            ("continuous", arch, kw["kv_layout"])))
    monkeypatch.setattr(engine_serve, "serve_round",
                        lambda arch, *a, **kw: seen.append(("round", arch)))
    for arch in ("arctic-480b", "llama4-maverick-400b-a17b"):
        serve_cli.main(["--engine", "--arch", arch, "--device", "cpu"])
        for layout in ("paged", "dense"):
            serve_cli.main(["--engine", "--arch", arch, "--exec-mode",
                            "continuous", "--kv-layout", layout, "--device",
                            "cpu"])
    assert seen == [(mode, arch, *lay) for arch in
                    ("arctic-480b", "llama4-maverick-400b-a17b")
                    for mode, lay in (("round", ()),
                                      ("continuous", ("paged",)),
                                      ("continuous", ("dense",)))]
