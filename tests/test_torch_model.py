"""The port's model (``repro_torch.models``) against the JAX ``Model`` on
the same weights, on the CPU.

Weights come from ``repro.models.transformer.init_params`` and cross
through ``repro_torch.models.bridge``; configs cross through
``dataclasses.asdict``; inputs are numpy from a seed. Cases: the tiny
dense model (untied head, no qk-norm), the tail config (units plus an
unrolled tail layer) and reduced qwen3-0.6b (GQA with 2 query heads per
KV head, qk-norm, tied head).

Tolerance: logits atol 1e-4 (fp32 through a few layers and a vocabulary
projection, summed in another order), with identical argmax; block-pool
contents atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.config import get_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.config import get_reduced_config as torch_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_jax, unstack_layers
from repro_torch.models.layers import apply_embed
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import init_params, make_cache

LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFGS = {"tiny": TINY, "tail": KIND_CFGS["tail"],
        "qwen3-0.6b": get_reduced_config("qwen3-0.6b")}


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


_CACHE = {}


def _pair(name):
    """(jax cfg, jax model, jax params, torch cfg, torch model, params)."""
    if name not in _CACHE:
        cfg = CFGS[name]
        jm = jax_build_model(cfg, remat=False)
        jp = jm.init(jax.random.PRNGKey(1))
        tcfg = _torch_cfg(cfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _CACHE[name] = (cfg, jm, jp, tcfg, build_model(tcfg), tp)
    return _CACHE[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pools_equal(jcache, tcache, cfg, ids):
    """Pool blocks ``ids`` of every layer agree across the two sides."""
    for jl, tl in zip(unstack_layers(jcache, cfg), tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy()[ids],
                                       np.asarray(jl[key])[ids],
                                       atol=POOL_ATOL, rtol=0)


def test_config_copy_matches_reference():
    """The port's registry and reduction give the reference's configs."""
    for arch in ("qwen3-0.6b",):
        ref = dataclasses.asdict(get_reduced_config(arch))
        assert dataclasses.asdict(torch_reduced_config(arch)) == ref


@pytest.mark.parametrize("name", sorted(CFGS))
def test_bridge_unstacks_layers_in_order(name):
    """Layer l of the port is unit l // k, pattern position l % k of the
    reference, then the tail; nothing is transposed."""
    cfg, _, jp, tcfg, _, tp = _pair(name)
    assert len(tp["layers"]) == cfg.n_layers
    k = len(cfg.block_pattern)
    n_units = cfg.n_layers // k
    for li, layer in enumerate(tp["layers"]):
        if li < n_units * k:
            want = np.asarray(jp["units"][li % k]["attn"]["wq"][li // k])
        else:
            want = np.asarray(jp["tail"][li - n_units * k]["attn"]["wq"])
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), want)
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jp["embed"]))
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)


def _prefill_both(name, T, pos0, bs=8, nb=6, seed=0):
    """One chunk of T tokens at position pos0 for B=2 sequences through
    both models on identical pools. Returns both logits and caches."""
    cfg, jm, jp, tcfg, tm, tp = _pair(name)
    rng = np.random.default_rng(seed)
    B, n_pool = 2, 2 * nb + 1
    tables = rng.permutation(np.arange(1, n_pool)).reshape(B, nb).astype(
        np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.array([pos0, pos0 + 3], np.int32)
    jc = jm.init_paged_cache(B, nb * bs, n_pool, bs)
    tc = tm.init_paged_cache(B, nb * bs, n_pool, bs, device="cpu")
    jl, jc = jm.prefill_chunk(jp, jc, {"tokens": jnp.asarray(toks),
                                       "pos": jnp.asarray(pos),
                                       "block_tables": jnp.asarray(tables)})
    tl, tc = tm.prefill_chunk(tp, tc, {"tokens": _t(toks), "pos": _t(pos),
                                       "block_tables": _t(tables)})
    return cfg, (jm, jp, jc), (tm, tp, tc), np.asarray(jl), tl.numpy(), \
        tables, pos


@pytest.mark.parametrize("name", ["qwen3-0.6b", "tiny"])
def test_prefill_chunk_and_decode_match_reference(name):
    """A mid-block chunk, then two decode steps: logits allclose with
    identical argmax, and the written pool blocks agree."""
    cfg, (jm, jp, jc), (tm, tp, tc), jl, tl, tables, pos = _prefill_both(
        name, T=11, pos0=5)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    _pools_equal(jc, tc, cfg, np.unique(tables))
    pos = pos + 11
    tok = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(2):
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos),
                                         "block_tables": jnp.asarray(tables)})
        tl, tc = tm.decode_step(tp, tc, {"tokens": _t(tok), "pos": _t(pos),
                                         "block_tables": _t(tables)})
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        tok = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    _pools_equal(jc, tc, cfg, np.unique(tables))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "tail"])
def test_chunked_prefill_equals_single_chunk(name):
    """A prompt prefilled in pieces (16 + 8 + 4 + 2 over blocks of 8, the
    last starting mid-block) leaves the same last logits and the same
    pool as one chunk."""
    cfg, _, _, tcfg, tm, tp = _pair(name)
    rng = np.random.default_rng(3)
    bs, nb = 8, 4
    toks = rng.integers(0, cfg.vocab_size, (1, 30)).astype(np.int32)
    table = _t(np.arange(1, nb + 1, dtype=np.int32)[None])
    one = tm.init_paged_cache(1, nb * bs, nb + 1, bs, device="cpu")
    want, one = tm.prefill_chunk(tp, one, {"tokens": _t(toks),
                                           "pos": _t(np.int32([0])),
                                           "block_tables": table})
    many = tm.init_paged_cache(1, nb * bs, nb + 1, bs, device="cpu")
    p = 0
    for c in (16, 8, 4, 2):
        got, many = tm.prefill_chunk(tp, many, {
            "tokens": _t(toks[:, p:p + c]), "pos": _t(np.int32([p])),
            "block_tables": table})
        p += c
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    for a, b in zip(one, many):
        torch.testing.assert_close(a["k"][1:], b["k"][1:], atol=POOL_ATOL,
                                   rtol=0)


def test_write_paged_clamps_rows_past_the_table_into_the_null_block():
    """Explicit bounds: a chunk row whose logical block lies past the
    table's width lands in the null block 0 and never in a live block,
    where JAX's gather/scatter rules decide it implicitly."""
    bs, nb, KV, hd = 4, 2, 1, 4
    pool = torch.zeros((4, bs, KV, hd))
    tables = torch.tensor([[2, 3]], dtype=torch.int32)
    new = torch.arange(1, 6, dtype=torch.float32)[None, :, None, None] \
        .expand(1, 5, KV, hd).contiguous()
    # rows at positions 6..10: 6, 7 live in block 3; 8..10 are past nb*bs
    tattn._write_paged(pool, new, tables, torch.tensor([6],
                                                       dtype=torch.int32))
    assert pool[3, 2:, 0, 0].tolist() == [1.0, 2.0]
    assert pool[2].abs().sum() == 0 and pool[1].abs().sum() == 0
    assert pool[0, :3, 0, 0].tolist() == [3.0, 4.0, 5.0]  # null block sink


def test_embedding_rejects_out_of_range_ids():
    """The reference's jnp.take fills out-of-range ids with NaN rows and
    wraps negatives; the port raises."""
    table = torch.randn(5, 3)
    assert apply_embed(table, torch.tensor([[0, 4]])).shape == (1, 2, 3)
    for bad in (5, -1):
        with pytest.raises(IndexError):
            apply_embed(table, torch.tensor([[bad]]))


def test_unported_variants_raise():
    """The rotary variants and the encoder-decoder family are ported: they
    give the reference's outcome instead of raising (``rope2d`` and
    ``mrope`` its rotations, an encoder-decoder config its param layout,
    and a paged cache of it the reference's refusal). Windowed and
    recurrent layers under the paged layout keep their rings and per-slot
    states beside the block pool: the paged cache has the reference's
    layer shapes."""
    from repro.models.rope import apply_rope as jax_apply_rope
    from repro.models.transformer import init_params as jax_init_params
    from repro.models.transformer import make_cache as jax_make_cache

    x = np.random.default_rng(0).standard_normal((1, 2, 1, 4)).astype(
        np.float32)
    pos = np.array([[3, 7]], np.int32)
    for variant in ("rope2d", "mrope"):
        np.testing.assert_allclose(
            apply_rope(_t(x), _t(pos), variant).numpy(),
            np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      variant)), atol=1e-6, rtol=0)
    jcfg = dataclasses.replace(TINY, name="tiny-encdec", enc_dec=True,
                               n_enc_layers=2)
    got = init_params(_torch_cfg(jcfg), device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jcfg)), _torch_cfg(jcfg))
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"][0]) == sorted(want["layers"][0])
    assert len(got["encoder"]["layers"]) == 2
    for fn in (lambda: jax_make_cache(jcfg, 2, 40, jnp.float32,
                                      paged=(4, 8)),
               lambda: make_cache(_torch_cfg(jcfg), 2, 40, torch.float32,
                                  paged=(4, 8), device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="do not support encoder-decoder"):
            fn()
    for name in ("rglru", "rwkv", "windowed", "swa"):
        jcfg = KIND_CFGS[name]
        cfg = _torch_cfg(jcfg)
        init_params(cfg, device="cpu")
        got = make_cache(cfg, 2, 40, torch.float32, paged=(4, 8),
                         device="cpu")
        want = unstack_layers(jax_make_cache(jcfg, 2, 40, jnp.float32,
                                             paged=(4, 8)), jcfg)
        assert [sorted(c) for c in got] == [sorted(c) for c in want], name
        for g, w in zip(got, want):
            for key, t in g.items():
                assert tuple(t.shape) == w[key].shape, (name, key)
                assert not t.any()
    for name in ("windowed", "swa"):
        cfg = _torch_cfg(KIND_CFGS[name])
        dense = make_cache(cfg, 2, 40, torch.float32, device="cpu")
        assert [c["k"].shape[1] for c in dense] == [cfg.sliding_window] * 2


def test_init_params_is_seeded_and_on_the_requested_device():
    cfg = _torch_cfg(TINY)
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"][1]["ffn"]["w_up"],
                       b["layers"][1]["ffn"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].device.type == "cpu"
    # the reference's distributions: embed std 0.02, dense 1/sqrt(d_in)
    big = init_params(_torch_cfg(CFGS["qwen3-0.6b"]), device="cpu")
    assert abs(float(big["embed"].std()) - 0.02) < 1e-3
    wq = big["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - wq.shape[0] ** -0.5) < 2e-3
