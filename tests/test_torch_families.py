"""The port's remaining model families against the JAX package, on the
CPU: chatglm3-6b (``rope2d``), qwen2-vl-7b (M-RoPE and the vision
frontend), seamless-m4t-large-v2 (encoder-decoder), starcoder2-15b
(sliding window, plain GELU MLP, LayerNorm) and yi-34b, at their reduced
configs.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.models.bridge``; configs through ``dataclasses.asdict``;
inputs (tokens and frontend embeddings) are numpy from a seed.
Tolerances: logits atol 1e-4 (fp32 through a few layers and a vocabulary
projection, summed in another order), caches atol 1e-5, rotary
embeddings atol 1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import get_reduced_config
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.models import build_model as jax_build_model
from repro.models import rope as jrope
from repro.models.transformer import make_cache as jax_make_cache
from repro.models.transformer import pad_cache as jax_pad_cache
from repro_torch.config import get_config, get_reduced_config as t_reduced
from repro_torch.config.base import ModelConfig
from repro_torch.configs import ASSIGNED
from repro_torch.models import build_model
from repro_torch.models import rope as trope
from repro_torch.models.bridge import params_from_jax, unstack_layers
from repro_torch.models.transformer import (init_params, make_cache,
                                            pad_cache)

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
ROPE_ATOL = 1e-6
FAMILIES = ("chatglm3-6b", "qwen2-vl-7b", "seamless-m4t-large-v2",
            "starcoder2-15b", "yi-34b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


_CACHE = {}


def _pair(arch):
    """(jax cfg, jax model, jax params, torch cfg, torch model, params)."""
    if arch not in _CACHE:
        cfg = get_reduced_config(arch)
        jm = jax_build_model(cfg, remat=False, attn_impl="naive")
        jp = jm.init(jax.random.PRNGKey(1))
        tcfg = _torch_cfg(cfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _CACHE[arch] = (cfg, jm, jp, tcfg, build_model(tcfg), tp)
    return _CACHE[arch]


def _batch(cfg, B, S, seed):
    """Seeded numpy tokens, plus frontend or frame embeddings where the
    config has a frontend (frames: the engines' max(8, S // 4) rows)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.enc_dec:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, max(8, S // 4), cfg.d_model)).astype(np.float32)
    elif cfg.frontend is not None:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _caches_close(jcache, tcache, cfg, atol=CACHE_ATOL):
    for jl, tl in zip(unstack_layers(jcache, cfg), tcache):
        assert sorted(jl) == sorted(tl)
        for key, t in tl.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jl[key]),
                                       atol=atol, rtol=0, err_msg=key)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_equal_the_references(arch):
    """Full and reduced configs are copies of the reference's."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(t_reduced(arch)) == \
        dataclasses.asdict(get_reduced_config(arch))


def test_full_configs_match_assignment():
    """The reference's table of the ten assigned architectures
    (tests/test_arch_smoke.py), read from the port's registry."""
    assert ASSIGNED == JAX_ASSIGNED
    spec = {
        "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 8192, 202048, 128),
        "rwkv6-3b": (32, 2560, None, None, 8960, 65536, 0),
        "starcoder2-15b": (40, 6144, 48, 4, 24576, 49152, 0),
        "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064, 0),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000, 0),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024, 0),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256208, 0),
        "yi-34b": (60, 7168, 56, 8, 20480, 64000, 0),
        "arctic-480b": (35, 7168, 56, 8, 4864, 32000, 128),
        "qwen3-0.6b": (28, 1024, 16, 8, 3072, 151936, 0),
    }
    assert sorted(spec) == sorted(ASSIGNED)
    for arch, (L, d, H, KV, ff, V, E) in spec.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
                cfg.n_experts) == (L, d, ff, V, E), arch
        if H is not None:
            assert (cfg.n_heads, cfg.n_kv_heads) == (H, KV), arch


@pytest.mark.parametrize("arch,target,tol", [
    ("yi-34b", 34e9, 0.15), ("starcoder2-15b", 15e9, 0.25)])
def test_param_count_estimates(arch, target, tol):
    """The reference's analytic counts land near the advertised sizes, and
    the port's copy gives the same numbers."""
    got = get_config(arch).param_count_estimate()
    assert got == jax_get_config(arch).param_count_estimate()
    assert math.isclose(got, target, rel_tol=tol)


# ---------------------------------------------------------------- rotary
@pytest.mark.parametrize("variant,hd", [("rope2d", 64), ("rope2d", 128),
                                        ("mrope", 64), ("mrope", 128)])
def test_rope_variants_equal_the_references(variant, hd):
    """``rope2d`` and ``mrope`` (text positions, then vision-grid ids
    ahead of linear text positions) against the reference's
    ``apply_rope``."""
    rng = np.random.default_rng(hd)
    B, F, S = 2, 9, 14
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos = np.array(jrope.default_positions(B, S, offset=5))
    np.testing.assert_array_equal(
        trope.default_positions(B, S, offset=5).numpy(), pos)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), variant,
                            theta=1e6)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           variant, theta=1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ROPE_ATOL, rtol=0)
    if variant != "mrope":
        return
    jgrid = jrope.vision_grid_positions(B, F, 3)
    tgrid = trope.vision_grid_positions(B, F, 3)
    lin = np.asarray(jrope.default_positions(B, S - F, offset=F))
    ids = [np.concatenate([np.asarray(j), lin], 1) for j in jgrid]
    for j, t in zip(jgrid, tgrid):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), "mrope",
                            mrope_positions=tuple(map(jnp.asarray, ids)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           "mrope", mrope_positions=tuple(
                               torch.from_numpy(i) for i in ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ROPE_ATOL, rtol=0)


def test_rope2d_rotates_only_half():
    """The reference's property test, on the port."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 1, 64)).astype(
        np.float32))
    y = trope.apply_rope(x, trope.default_positions(1, 4), "rope2d")
    assert torch.equal(x[..., 32:], y[..., 32:])
    assert not torch.allclose(x[:, 1:, :, :32], y[:, 1:, :, :32])


def test_mrope_equals_rope_for_text():
    """The reference's property test, on the port: with t = h = w =
    linear positions M-RoPE is plain RoPE."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 6, 1, 64)).astype(
        np.float32))
    pos = trope.default_positions(1, 6)
    y1 = trope.apply_rope(x, pos, "mrope", mrope_positions=(pos, pos, pos))
    y2 = trope.apply_rope(x, pos, "mrope")
    y3 = trope.apply_rope(x, pos, "rope")
    torch.testing.assert_close(y1, y2, atol=ROPE_ATOL, rtol=0)
    torch.testing.assert_close(y2, y3, atol=ROPE_ATOL, rtol=0)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_round_trips(arch):
    """The bridged params have the port's own layout: the keys and
    shapes ``init_params`` draws (frontend_proj, the encoder's layers in
    order, the decoder layers' cross branch), and the encoder's layer i
    is the reference's stacked slice i."""
    cfg, _, jp, tcfg, _, tp = _pair(arch)
    own = init_params(tcfg, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(tp) == shapes(own)
    assert ("frontend_proj" in tp) == (cfg.frontend is not None)
    assert ("cross" in tp["layers"][0]) == cfg.enc_dec
    if cfg.enc_dec:
        assert len(tp["encoder"]["layers"]) == cfg.n_enc_layers
        for i, layer in enumerate(tp["encoder"]["layers"]):
            np.testing.assert_array_equal(
                layer["attn"]["wq"].numpy(),
                np.asarray(jp["encoder"]["layers"]["attn"]["wq"][i]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill logits (1e-4) and caches (1e-5, cross K/V included), then
    four greedy decode steps' logits (1e-4) over the padded caches, from
    position F + S for a frontend model."""
    cfg, jm, jp, tcfg, tm, tp = _pair(arch)
    B, S = 2, 12
    jb, tb = _both(_batch(cfg, B, S, seed=3))
    jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _caches_close(jc, tc, cfg)
    if cfg.enc_dec:
        assert tuple(tc[0]["ck"].shape) == (B, 8, cfg.n_kv_heads,
                                            cfg.head_dim)
    jc, tc = jax_pad_cache(cfg, jc, 4), pad_cache(tcfg, tc, 4)
    F = cfg.frontend_tokens if cfg.frontend and not cfg.enc_dec else 0
    pos = np.full((B,), F + S, np.int32)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok[:, None]),
                                         "pos": jnp.asarray(pos)})
        tl, tc = tm.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok[:, None]), "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert (np.argmax(tl.numpy(), -1) == np.argmax(np.asarray(jl),
                                                       -1)).all()
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
        pos = pos + 1
    _caches_close(jc, tc, cfg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """Teacher-forced decode reproduces the full-sequence logits (the
    reference's test, on the port): prefill S - 1 tokens, decode the
    last one at position F + S - 1."""
    cfg, _, _, tcfg, tm, tp = _pair(arch)
    B, S = 2, 12
    batch = _batch(cfg, B, S, seed=5)
    _, tb = _both(batch)
    full, _ = tm.prefill(tp, tb)
    short = dict(tb, tokens=tb["tokens"][:, :-1])
    if cfg.enc_dec:  # the same encoder input as the full forward
        short["frontend_embeds"] = tb["frontend_embeds"]
    _, cache = tm.prefill(tp, short)
    cache = pad_cache(tcfg, cache, 2)
    F = cfg.frontend_tokens if cfg.frontend and not cfg.enc_dec else 0
    step, _ = tm.decode_step(tp, cache, {
        "tokens": tb["tokens"][:, -1:],
        "pos": torch.full((B,), F + S - 1, dtype=torch.int32)})
    torch.testing.assert_close(step, full, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dense_cache_matches_the_references(arch):
    """``make_cache`` has the reference's per-layer keys and shapes (an
    encoder-decoder layer's ``ck``/``cv`` at ``enc_len(cache_len)``
    rows); a paged cache of an encoder-decoder model raises as the
    reference's does."""
    cfg, _, _, tcfg, _, _ = _pair(arch)
    got = make_cache(tcfg, 2, 40, torch.float32, device="cpu")
    want = unstack_layers(jax_make_cache(cfg, 2, 40, jnp.float32), cfg)
    for g, w in zip(got, want):
        assert {k: tuple(t.shape) for k, t in g.items()} == \
            {k: tuple(t.shape) for k, t in w.items()}
    if not cfg.enc_dec:
        return
    for fn in (lambda: jax_make_cache(cfg, 2, 40, jnp.float32, paged=(4, 8)),
               lambda: make_cache(tcfg, 2, 40, torch.float32, paged=(4, 8),
                                  device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="do not support encoder-decoder"):
            fn()


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_chunk_and_verify_refuse_frontend_prompts(arch):
    """``prefill_chunk`` and ``verify_step`` raise the reference's
    ``NotImplementedError`` for frontend and encoder-decoder models."""
    cfg, jm, jp, tcfg, tm, tp = _pair(arch)
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "pos": np.zeros((1,), np.int32)}
    jb, tb = _both(batch)
    for fn, what in (("prefill_chunk", "prefill_chunk"),
                     ("verify_step", "verify_step")):
        for model, params, b in ((jm, jp, jb), (tm, tp, tb)):
            with pytest.raises(NotImplementedError,
                               match=f"{what} supports plain token"):
                getattr(model, fn)(params, None, b)
