"""The port's MoE family (``models.moe``, the MoE and ``attn_dense`` layer
kinds, the bridge of the expert leaves) against the JAX package on the
same weights, on the CPU.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.models.bridge``; configs cross through
``dataclasses.asdict``; inputs are numpy from a seed. Configs: reduced
``arctic-480b`` (top-2 over 4 experts with the dense residual MLP beside
them, 4 query heads over 1 KV head) and reduced
``llama4-maverick-400b-a17b`` (an ``attn_dense`` layer, then a top-1 MoE
layer). The reduced configs set ``capacity_factor`` 8.0, where nothing
is dropped; the published 1.25 and 1.0 are run too, and at 1.0 entries
are dropped.

Tolerances: ``moe_apply``'s output atol 1e-5 / rtol 1e-4 (fp32, the same
products summed in another order); ``lb_loss`` and ``z_loss`` rtol 1e-6;
the drop count exact (``drop_frac`` times the N*k entries: XLA's mean
rounds 1.0 to 1 + 2.4e-8, so the fractions differ by an ulp); logits
atol 1e-4 with identical argmax, K/V atol 1e-5 (as
tests/test_torch_model.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config, get_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.config import get_config as torch_config
from repro_torch.config import get_reduced_config as torch_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_jax, unstack_layers
from repro_torch.models.transformer import init_params

ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")
Y_TOL = dict(atol=1e-5, rtol=1e-4)
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_CACHE = {}


def _pair(arch, cf=None):
    """(jax cfg, jax model, jax params, torch cfg, torch model, params) of
    the reduced ``arch`` at capacity factor ``cf`` (default: the reduced
    config's 8.0). The weights do not depend on ``cf``."""
    key = (arch, cf)
    if key not in _CACHE:
        cfg = get_reduced_config(arch)
        if cf is not None:
            cfg = dataclasses.replace(cfg, name=f"{arch}-cf{cf}",
                                      capacity_factor=cf)
        base = _pair(arch) if cf is not None else None
        jm = jax_build_model(cfg, remat=False)
        jp = base[2] if base else jm.init(jax.random.PRNGKey(1))
        tcfg = _torch_cfg(cfg)
        tp = base[5] if base else params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg)
        _CACHE[key] = (cfg, jm, jp, tcfg, build_model(tcfg), tp)
    return _CACHE[key]


def test_config_copies_match_reference():
    """The port's registry and reductions give the reference's configs:
    4 experts, capacity factor 8.0, the widths of default_reduce."""
    for arch in ARCHS:
        assert dataclasses.asdict(torch_config(arch)) == \
            dataclasses.asdict(get_config(arch))
        red = torch_reduced_config(arch)
        assert dataclasses.asdict(red) == \
            dataclasses.asdict(get_reduced_config(arch))
        assert red.n_experts == 4 and red.capacity_factor == 8.0


@pytest.mark.parametrize("cf", [8.0, 1.25, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    """One MoE layer's bridged weights, x (4, 32, d): N = 128 rows, so at
    cf 1.0 the capacity (32 slots top-1, 64 top-2) holds exactly the mean
    load and any imbalance drops. y, the aux losses and the dropped
    entries; nothing dropped at 8.0, some at 1.0."""
    cfg, _, _, tcfg, _, tp = _pair(arch, cf)
    li = list(cfg.layer_kinds()).index("attn")
    p = tp["layers"][li]["ffn"]
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    x = np.random.default_rng(5).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=2)(
        jp, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_apply(p, _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6)
    n = 128 * cfg.top_k
    dropped = round(float(taux["drop_frac"]) * n)
    assert dropped == round(float(jaux["drop_frac"]) * n)
    assert abs(float(taux["drop_frac"]) - dropped / n) < 1e-7
    assert (dropped > 0) == (cf == 1.0)
    assert tmoe._capacity(128, tcfg) == jmoe._capacity(128, cfg)


def test_capacity_formula():
    """int(cf * N * k / E), at least 8, rounded up to a multiple of 8."""
    cfg = _torch_cfg(dataclasses.replace(get_reduced_config(ARCHS[0]),
                                         capacity_factor=1.25))
    got = [tmoe._capacity(n, cfg) for n in (1, 8, 16, 37, 100, 4096)]
    assert got == [8, 8, 16, 24, 64, 2560]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_moe_leaves(arch):
    """Expert leaves arrive as (n_units, E, d, f) and leave as (E, d, f)
    (only the unit axis is split off), the router as (d, E), arctic's
    dense residual MLP beside them; llama4's ``attn_dense`` layer has a
    dense MLP of width ``dense_ff``. The port's own init gives the same
    structure and shapes."""
    cfg, _, jp, tcfg, _, tp = _pair(arch)
    jl = unstack_layers(jax.tree.map(np.asarray, jp), cfg)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    own = init_params(tcfg, seed=0, device="cpu")
    for kind, want, got, mine in zip(cfg.layer_kinds(), jl, tp["layers"],
                                     own["layers"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node, node_own = got, mine
            for k in path:
                node, node_own = node[k.key], node_own[k.key]
            np.testing.assert_array_equal(node.numpy(), leaf)
            assert tuple(node_own.shape) == leaf.shape
        ffn = got["ffn"]
        if kind == "attn_dense":
            assert ffn["w_up"].shape == (d, cfg.dense_ff)
            continue
        assert ffn["router"].shape == (d, E)
        assert ffn["w_gate"].shape == ffn["w_up"].shape == (E, d, f)
        assert ffn["w_down"].shape == (E, f, d)
        assert ("dense_mlp" in ffn) == cfg.moe_dense_residual
    # the init's distributions: router std 0.02, experts 1/sqrt(fan-in)
    ffn = own["layers"][list(cfg.layer_kinds()).index("attn")]["ffn"]
    assert abs(float(ffn["router"].std()) - 0.02) < 2e-3
    assert abs(float(ffn["w_gate"].std()) - d ** -0.5) < 2e-3
    assert abs(float(ffn["w_down"].std()) - f ** -0.5) < 2e-3


def _layers_kv_equal(jcache, tcache, cfg, ids=None):
    for jl, tl in zip(unstack_layers(jcache, cfg), tcache):
        for key in ("k", "v"):
            got, want = tl[key].numpy(), np.asarray(jl[key])
            if ids is not None:
                got, want = got[ids], want[ids]
            np.testing.assert_allclose(got, want, atol=KV_ATOL, rtol=0)


def _logits_equal(tl, jl):
    tl, jl = tl.numpy(), np.asarray(jl)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("layout,cf", [("paged", None), ("dense", None),
                                       ("dense", 1.0)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, layout, cf):
    """Dense: a one-shot prefill of 2 prompts of 24 tokens (at cf 1.0
    the 48 rows drop entries, alike on both sides), every layer's K/V,
    then two decode steps over the padded cache. Paged: a mid-block chunk
    of 11 tokens for 2 sequences on identical pools, then two decode
    steps through the tables."""
    cfg, jm, jp, _, tm, tp = _pair(arch, cf)
    rng = np.random.default_rng(6)
    B = 2
    if layout == "dense":
        from repro.models.transformer import pad_cache as jpad
        from repro_torch.models.transformer import pad_cache as tpad
        toks = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
        _logits_equal(tl, jl)
        _layers_kv_equal(jc, tc, cfg)
        jc, tc = jpad(cfg, jc, 2), tpad(tm.cfg, tc, 2)
        pos, extra = np.full((B,), 24, np.int32), {}
    else:
        bs, nb = 8, 6
        n_pool = B * nb + 1
        tables = rng.permutation(np.arange(1, n_pool)).reshape(
            B, nb).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, 11)).astype(np.int32)
        pos = np.array([5, 8], np.int32)
        jc = jm.init_paged_cache(B, nb * bs, n_pool, bs)
        tc = tm.init_paged_cache(B, nb * bs, n_pool, bs, device="cpu")
        extra = {"block_tables": tables}
        jl, jc = jm.prefill_chunk(jp, jc, {
            "tokens": jnp.asarray(toks), "pos": jnp.asarray(pos),
            "block_tables": jnp.asarray(tables)})
        tl, tc = tm.prefill_chunk(tp, tc, {
            "tokens": _t(toks), "pos": _t(pos), "block_tables": _t(tables)})
        _logits_equal(tl, jl)
        _layers_kv_equal(jc, tc, cfg, np.unique(tables))
        pos = pos + 11
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(2):
        jb = {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        tb = {"tokens": _t(tok), "pos": _t(pos),
              **{k: _t(v) for k, v in extra.items()}}
        jl, jc = jm.decode_step(jp, jc, jb)
        tl, tc = tm.decode_step(tp, tc, tb)
        _logits_equal(tl, jl)
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_shot(arch):
    """At capacity factor 8.0 (no drops, so N does not matter) a 30-token
    prompt prefilled in pieces of 16 + 8 + 4 + 2 leaves the last logits
    and the pool of one chunk, and of the one-shot dense prefill."""
    cfg, _, _, _, tm, tp = _pair(arch)
    toks = _t(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 30)).astype(np.int32))
    bs, nb = 8, 4
    table = _t(np.arange(1, nb + 1, dtype=np.int32)[None])
    one = tm.init_paged_cache(1, nb * bs, nb + 1, bs, device="cpu")
    want, one = tm.prefill_chunk(tp, one, {
        "tokens": toks, "pos": _t(np.int32([0])), "block_tables": table})
    many = tm.init_paged_cache(1, nb * bs, nb + 1, bs, device="cpu")
    p = 0
    for c in (16, 8, 4, 2):
        got, many = tm.prefill_chunk(tp, many, {
            "tokens": toks[:, p:p + c], "pos": _t(np.int32([p])),
            "block_tables": table})
        p += c
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    for a, b in zip(one, many):
        torch.testing.assert_close(a["k"][1:], b["k"][1:], atol=KV_ATOL,
                                   rtol=0)
    dense, _ = tm.prefill(tp, {"tokens": toks})
    torch.testing.assert_close(dense, want, atol=LOGIT_ATOL, rtol=0)
