"""Tensor-parallel serving on the CPU: the port's engine on a
``("model",)`` mesh against its own tp = 1 engine and the reference's
engine (the reference's tests/test_sharded_engine.py, mirrored).

The reference runs its sharded engine in a subprocess with forced host
devices; the port's ranks all sit on the CPU device of this process
(``make_tp_mesh(tp, ["cpu"] * tp)``). Weights are the reference's,
bridged. The bar is the reference's: greedy tokens identical across
layouts (paged with and without the prefix cache and a token budget,
dense, ``share_from``), speculation, and TP degrees 2 and 4; the
rank-split forward's logits within 1e-5 of the unsplit one's, the
RG-LRU, RWKV-6 and MoE stacks' included (their engines:
test_torch_tp_recurrent.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS
from repro.config.base import ModelConfig as JaxModelConfig
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config import get_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.launch.mesh import TPMesh, make_tp_mesh
from repro_torch.models import build_model
from repro_torch.models.tp import TPModel
from repro_torch.serving.engine import ContinuousBatchingEngine

SPEC2 = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=2, d_ff=64, vocab_size=97)
SPEC4 = dict(SPEC2, name="tiny4", n_heads=4, n_kv_heads=4)
SPECS = {2: SPEC2, 4: SPEC4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prompts(vocab, seed=7):
    """A shared-prefix family (a prefix-cache hit and a fully covering
    duplicate) and a one-off, as the reference's test."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 20).astype(np.int32)
    ps = [np.concatenate([shared, rng.integers(1, vocab, n).astype(np.int32)])
          for n in (4, 12)]
    ps += [rng.integers(1, vocab, 9).astype(np.int32), ps[0].copy()]
    return ps


def _mesh(tp):
    return make_tp_mesh(tp, ["cpu"] * tp)


_JAX = {}


def _jax(spec, **kw):
    """The reference engine's streams (unsharded) and its params."""
    key = (spec["name"], tuple(sorted(kw.items())))
    if key not in _JAX:
        eng = JaxEngine(JaxModelConfig(**spec), max_slots=3, max_seq=128,
                        seed=0, **kw)
        _JAX[key] = (jax.tree.map(np.asarray, eng.params),
                     [r.tokens.tolist() for r in eng.run(
                         prompts(spec["vocab_size"]), max_new_tokens=8)])
    return _JAX[key]


def _toks(spec, mesh, params, share_from=None, **kw):
    eng = ContinuousBatchingEngine(ModelConfig(**spec), max_slots=3,
                                   max_seq=128, mesh=mesh, device="cpu",
                                   share_from=share_from, **kw)
    if share_from is None:
        eng.load_jax_params(params)
    return eng, [r.tokens.tolist() for r in eng.run(
        prompts(spec["vocab_size"]), max_new_tokens=8)]


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_engine_token_identity(tp):
    """Sharded greedy streams == the port's tp = 1 engine's == the
    reference engine's, paged (with and without the prefix cache and a
    token budget), dense, and sharing a donor's weights. TINY2's 97-entry
    vocabulary stays replicated (``_fit_mesh``) while the heads split."""
    spec = SPECS[tp]
    params, ref = _jax(spec, kv_layout="paged", block_size=8)
    _, one = _toks(spec, None, params, kv_layout="paged", block_size=8)
    donor, got = _toks(spec, _mesh(tp), params, kv_layout="paged",
                       block_size=8)
    assert one == ref and got == ref
    assert donor.tp_degree == tp and donor.stats()["tp_degree"] == tp
    assert len(donor.cache) == tp and len(donor.params) == tp
    kv = donor.cache[0][0]["k"].shape
    assert kv[2] == spec["n_kv_heads"] // tp
    _, got = _toks(spec, _mesh(tp), params, kv_layout="paged", block_size=8,
                   prefix_cache=True, token_budget=24)
    assert got == ref
    dparams, dref = _jax(spec)
    _, got = _toks(spec, _mesh(tp), dparams)
    assert got == dref
    _, got = _toks(spec, _mesh(tp), None, share_from=donor,
                   kv_layout="paged", block_size=8)
    assert got == ref
    with pytest.raises(ValueError, match="different mesh"):
        _toks(spec, None, None, share_from=donor, kv_layout="paged",
              block_size=8)


def test_sharded_engine_speculative_identity():
    """Speculative decode (propose, verify, roll back) at tp = 2 with the
    prefix cache stays identical to the plain-decode streams."""
    params, ref = _jax(SPEC2, kv_layout="paged", block_size=8)
    eng, got = _toks(SPEC2, _mesh(2), params, kv_layout="paged",
                     block_size=8, prefix_cache=True, spec_k=3)
    assert got == ref and eng.n_spec_steps > 0


def test_windowed_stack_token_identity():
    """A stack with a windowed layer (rings stay per slot beside the
    pool, so chunks go through the staging cache and its graft) at tp = 2
    against tp = 1 and the reference, paged and dense."""
    jcfg = KIND_CFGS["windowed"]
    spec = dataclasses.asdict(jcfg)
    for kw in ({"kv_layout": "paged", "block_size": 8}, {}):
        params, ref = _jax(spec, **kw)
        _, got = _toks(spec, _mesh(2), params, **kw)
        assert got == ref, kw


def _logit_cases():
    """Reduced configs with two KV heads: qk-norm and a tied,
    vocabulary-split head (qwen3), rope2d (chatglm3), sliding-window rings
    and an untied head (starcoder2); the hybrid RG-LRU and the RWKV-6 TINY
    stacks (width and heads split) and reduced arctic-480b (experts split,
    a dense residual MLP beside them)."""
    return [dataclasses.replace(get_reduced_config(a), n_kv_heads=2)
            for a in ("qwen3-0.6b", "chatglm3-6b", "starcoder2-15b",
                      "arctic-480b")] + [
        ModelConfig(**dataclasses.asdict(KIND_CFGS[k]))
        for k in ("rglru", "rwkv")]


#: the dim each cache leaf is cut along (KV by head, RG-LRU by width,
#: RWKV-6's state by head); shifts are whole on every rank
CACHE_CUT = {"k": 2, "v": 2, "h": -1, "conv": -1, "att_state": 1}


@pytest.mark.parametrize("cfg", _logit_cases(), ids=lambda c: c.name)
def test_rank_split_logits_match_unsplit(cfg):
    """prefill_chunk, decode_step and verify_step of the rank-split
    forward at tp = 2 (dense cache) and 4 (paged, where the heads allow)
    within 1e-5 absolute of ``Model``'s on the same params and inputs;
    the caches agree slice for slice."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    B, T = 2, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    for tp in (2,) + ((4,) if cfg.n_heads % 4 == 0 and
                      cfg.n_kv_heads % 4 == 0 else ()):
        tpm = TPModel(cfg, _mesh(tp))
        shards = tpm.shard_params(params)
        c1, cn = model.init_cache(B, 64, device="cpu"), tpm.init_cache(B, 64)
        pos = torch.zeros(B, dtype=torch.int64)
        a, _ = model.prefill_chunk(params, c1, {"tokens": toks, "pos": pos})
        b, _ = tpm.prefill_chunk(shards, cn, {"tokens": toks, "pos": pos})
        assert (a - b).abs().max() < 1e-5
        for j in range(3):
            batch = {"tokens": toks[:, j:j + 1], "pos": pos + T + j}
            a, _ = model.decode_step(params, c1, batch)
            b, _ = tpm.decode_step(shards, cn, batch)
            assert a.shape == b.shape and (a - b).abs().max() < 1e-5
        if "rglru" not in cfg.layer_kinds() and \
                "rwkv" not in cfg.layer_kinds():  # verify: rewindable only
            batch = {"tokens": toks[:, :4], "pos": pos + T + 3}
            a, _ = model.verify_step(params, c1, batch)
            b, _ = tpm.verify_step(shards, cn, batch)
            assert a.shape == b.shape and (a - b).abs().max() < 1e-5
        for layer, one in enumerate(c1):
            for key, t in one.items():
                parts = [c[layer][key] for c in cn]
                whole = torch.cat(parts, dim=CACHE_CUT[key]) \
                    if key in CACHE_CUT else parts[0]
                assert (whole - t).abs().max() < 1e-5, (layer, key)


def test_engine_refusals():
    """The reference's refusals under a mesh: no 'model' axis, a degree
    that does not divide the heads ("must divide"), a frontend model, the
    host tier; and an engine device that is not the mesh's. The RG-LRU,
    RWKV-6 and MoE stacks' own are in test_torch_tp_recurrent.py."""
    cfg = ModelConfig(**SPEC2)
    data = TPMesh((torch.device("cpu"),), ("data",), {"data": 1})
    with pytest.raises(ValueError, match="'model' axis"):
        ContinuousBatchingEngine(cfg, mesh=data, device="cpu")
    bad = ModelConfig(name="bad", family="dense", n_layers=1, d_model=30,
                      n_heads=3, n_kv_heads=3, d_ff=32, vocab_size=97)
    with pytest.raises(ValueError, match="must divide"):
        ContinuousBatchingEngine(bad, max_slots=1, max_seq=64,
                                 mesh=_mesh(2), device="cpu")
    vl = dataclasses.replace(get_reduced_config("qwen2-vl-7b"), n_kv_heads=2)
    with pytest.raises(NotImplementedError, match="frontend"):
        ContinuousBatchingEngine(vl, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="host KV tier"):
        ContinuousBatchingEngine(cfg, kv_layout="paged", kv_host_blocks=4,
                                 mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="not the mesh"):
        ContinuousBatchingEngine(cfg, mesh=TPMesh(
            (torch.device("meta"),) * 2, ("model",), {"model": 2}),
            device="cpu")
