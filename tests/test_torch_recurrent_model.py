"""The port's recurrent families (``models.rglru``, ``models.rwkv``, the
``rglru`` and ``rwkv`` layer kinds, layernorm and the GELU MLPs) against
the JAX package on the same weights, on the CPU.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.models.bridge``; configs cross through
``dataclasses.asdict``; inputs are numpy from a seed. Configs:
``KIND_CFGS["rglru"]`` (an rglru and a global attn layer),
``KIND_CFGS["rwkv"]`` (two RWKV layers, head size 32) and the reduced
``recurrentgemma-2b`` (rglru, rglru, local_attn with a 64-slot window,
geglu, tied head, softcap) and ``rwkv6-3b`` (layernorm, head size 64).

Tolerances: layers atol 1e-5 (fp32, a few products summed in another
order); logits atol 1e-4 with identical argmax (as
tests/test_torch_model.py); every cache leaf, recurrent states and the
K/V of attention layers behind recurrent ones, atol = rtol = 1e-4 (an
RWKV state sums S outer products of magnitude up to about 10, and the
rounding of the recurrences reaches the K/V projections after them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS
from repro.config import get_config, get_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro.models import rwkv as jrk
from repro_torch.config import get_config as torch_config
from repro_torch.config import get_reduced_config as torch_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv as trk
from repro_torch.models.bridge import params_from_jax, unstack_layers
from repro_torch.models.transformer import make_cache

LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
STATE_TOL = dict(atol=1e-4, rtol=1e-4)

CFGS = {"rglru": KIND_CFGS["rglru"], "rwkv": KIND_CFGS["rwkv"],
        "recurrentgemma-2b": get_reduced_config("recurrentgemma-2b"),
        "rwkv6-3b": get_reduced_config("rwkv6-3b")}


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


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


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


def _states_equal(jcache, tcache, cfg):
    """Every leaf of every layer's cache at STATE_TOL, shapes equal."""
    for li, (jl, tl) in enumerate(zip(unstack_layers(jcache, cfg), tcache)):
        assert sorted(tl) == sorted(jl), li
        for key, t in tl.items():
            want = np.asarray(jl[key])
            assert tuple(t.shape) == want.shape, (li, key)
            np.testing.assert_allclose(t.numpy(), want, **STATE_TOL,
                                       err_msg=f"layer {li} {key}")


def test_config_copies_match_reference():
    """The port's registry and reductions give the reference's configs."""
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        assert dataclasses.asdict(torch_config(arch)) == \
            dataclasses.asdict(get_config(arch))
        assert dataclasses.asdict(torch_reduced_config(arch)) == \
            dataclasses.asdict(get_reduced_config(arch))


@pytest.mark.parametrize("activation", ["silu", "geglu", "gelu"])
def test_norms_and_mlps_match_reference(activation):
    """layernorm (population variance, bias) and rmsnorm, the tanh GELU
    and the three MLP activations, against the reference's layers."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    for kind in ("layernorm", "rmsnorm"):
        p = {"scale": rng.standard_normal(24).astype(np.float32),
             "bias": rng.standard_normal(24).astype(np.float32)}
        if kind == "rmsnorm":
            del p["bias"]
        want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), kind)
        got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x),
                                 kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(tlayers.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=LAYER_ATOL, rtol=0)
    jp = jlayers.mlp_init(jax.random.PRNGKey(2), 24, 40,
                          activation in ("silu", "geglu"), jnp.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), activation)
    got = tlayers.apply_mlp({k: _t(v) for k, v in jp.items()}, _t(x),
                            activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)


def _layer(name, kind):
    """(torch cfg, the reference's and the port's params of the first
    layer of ``kind``)."""
    cfg, _, jp, tcfg, _, tp = _pair(name)
    li = list(cfg.layer_kinds()).index(kind)
    return cfg, tcfg, unstack_layers(jax.tree.map(np.asarray, jp),
                                     cfg)[li], tp["layers"][li]


def test_rglru_seq_and_decode_match_reference():
    """The Griffin block's sequence form from a carried (nonzero) state
    and two single-token steps after it: outputs and states."""
    cfg, tcfg, jl, tl = _layer("recurrentgemma-2b", "rglru")
    jrec = jax.tree.map(jnp.asarray, jl["rec"])
    rng = np.random.default_rng(1)
    w = cfg.rglru_width
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((2, w)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, w)).astype(np.float32)}
    seq = jax.jit(jrg.rglru_seq, static_argnums=2)
    dec = jax.jit(jrg.rglru_decode, static_argnums=2)
    jout, jst = seq(jrec, jnp.asarray(x), cfg,
                    jax.tree.map(jnp.asarray, state))
    tout, tst = trg.rglru_seq(tl["rec"], _t(x), tcfg,
                              {k: _t(v) for k, v in state.items()})
    for step in range(3):
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=LAYER_ATOL, rtol=0)
        for key in ("h", "conv"):
            np.testing.assert_allclose(tst[key].numpy(),
                                       np.asarray(jst[key]), **STATE_TOL)
        if step == 2:
            break
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = dec(jrec, jnp.asarray(x1), cfg, jst)
        tout, tst = trg.rglru_decode(tl["rec"], _t(x1), tcfg, tst)
    assert tst["h"].dtype == torch.float32


def test_rwkv_time_mix_and_channel_mix_match_reference():
    """RWKV-6 time-mix (sequence form from a carried state and shift,
    then two decode steps; H = d_model // head size) and channel-mix."""
    cfg, tcfg, jl, tl = _layer("rwkv6-3b", "rwkv")
    jtm = jax.tree.map(jnp.asarray, jl["time_mix"])
    jcm = jax.tree.map(jnp.asarray, jl["channel_mix"])
    d, hd = cfg.d_model, cfg.rwkv_head_size
    H = d // hd
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    st = (rng.standard_normal((2, H, hd, hd)) * 0.1).astype(np.float32)
    shift = rng.standard_normal((2, d)).astype(np.float32)
    seq = jax.jit(jrk.time_mix_seq, static_argnums=2)
    dec = jax.jit(jrk.time_mix_decode, static_argnums=2)
    j = seq(jtm, jnp.asarray(x), cfg, jnp.asarray(st), jnp.asarray(shift))
    t = trk.time_mix_seq(tl["time_mix"], _t(x), tcfg, _t(st), _t(shift))
    for step in range(3):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                   atol=LAYER_ATOL, rtol=0)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                                   **STATE_TOL)
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), atol=0)
        if step == 2:
            break
        x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
        j = dec(jtm, jnp.asarray(x1), cfg, j[1], j[2])
        t = trk.time_mix_decode(tl["time_mix"], _t(x1), tcfg, t[1], t[2])
    for s in (7, 1):
        jo, jsh = jrk.channel_mix(jcm, jnp.asarray(x[:, :s]),
                                  jnp.asarray(shift))
        to, tsh = trk.channel_mix(tl["channel_mix"], _t(x[:, :s]),
                                  _t(shift))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   atol=LAYER_ATOL, rtol=0)
        np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_bridge_carries_every_layer_kind(name):
    """Layer l of the port is unit l // k, pattern position l % k of the
    reference, then the tail, for the nested per-kind dicts too (rec,
    time_mix, channel_mix); nothing is transposed."""
    cfg, _, jp, _, _, tp = _pair(name)
    jl = unstack_layers(jax.tree.map(np.asarray, jp), cfg)
    assert len(tp["layers"]) == len(jl) == cfg.n_layers
    for kind, want, got in zip(cfg.layer_kinds(), jl, tp["layers"]):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) == len(jax.tree.leaves(
            jax.tree.map(lambda t: 0, got)))
        for path, leaf in flat_w:
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), leaf)
        assert ("rec" in got) == (kind == "rglru")
        assert ("time_mix" in got) == (kind == "rwkv")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_matches_reference(name):
    """``Model.prefill`` of 2 prompts of 80 tokens (past the reduced
    recurrentgemma's 64-slot window): last logits and every cache leaf
    (K/V rings and recurrent states) as the JAX model computes them."""
    cfg, jm, jp, _, tm, tp = _pair(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 80)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    _states_equal(jc, tc, cfg)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_chunked_prefill_equals_one_shot(name):
    """A 100-token prompt fed to ``prefill_chunk`` in pieces of 64 + 32 +
    4, the state carried across chunks (and, in the reduced
    recurrentgemma, the 64-slot ring wrapped), leaves the last logits and
    the cache of one single chunk; the decode step after both agrees."""
    cfg, _, _, tcfg, tm, tp = _pair(name)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 100)).astype(np.int32))
    one = tm.init_cache(1, 128, device="cpu")
    want, one = tm.prefill_chunk(tp, one, {
        "tokens": toks, "pos": torch.zeros(1, dtype=torch.int32)})
    many = tm.init_cache(1, 128, device="cpu")
    p = 0
    for c in (64, 32, 4):
        got, many = tm.prefill_chunk(tp, many, {
            "tokens": toks[:, p:p + c],
            "pos": torch.tensor([p], dtype=torch.int32)})
        p += c
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    for lo, lm in zip(one, many):
        for key in lo:
            torch.testing.assert_close(lm[key], lo[key], **STATE_TOL)
    batch = {"tokens": toks[:, -1:], "pos": torch.tensor([100],
                                                          dtype=torch.int32)}
    a, _ = tm.decode_step(tp, one, batch)
    b, _ = tm.decode_step(tp, many, batch)
    torch.testing.assert_close(a, b, atol=LOGIT_ATOL, rtol=0)


def test_recurrent_caches_and_paged_refusal():
    """Dense caches of the recurrent kinds are per-slot zero states
    (``h`` f32 whatever the dtype), rings for the local layers. Under the
    paged layout both families keep them beside the pool (neither has a
    linear attention layer, so the pool is empty): the reference's paged
    cache, layer for layer, in shape."""
    rg = _torch_cfg(CFGS["recurrentgemma-2b"])
    c = make_cache(rg, 3, 100, torch.float32, device="cpu")
    assert [sorted(x) for x in c] == [["conv", "h"], ["conv", "h"],
                                      ["k", "v"]]
    assert c[0]["h"].shape == (3, rg.rglru_width)
    assert c[0]["conv"].shape == (3, 3, rg.rglru_width)
    assert c[2]["k"].shape == (3, 64, rg.n_kv_heads, rg.head_dim)
    rw = _torch_cfg(CFGS["rwkv6-3b"])
    c = make_cache(rw, 2, 100, torch.float32, device="cpu")
    H = rw.d_model // rw.rwkv_head_size
    assert c[0]["att_state"].shape == (2, H, 64, 64)
    assert c[0]["att_shift"].shape == c[0]["ffn_shift"].shape == (2, 256)
    assert not any(t.any() for layer in c for t in layer.values())
    from repro.models.transformer import make_cache as jax_make_cache

    for name in ("recurrentgemma-2b", "rwkv6-3b"):
        jcfg = CFGS[name]
        got = make_cache(_torch_cfg(jcfg), 2, 100, torch.float32,
                         paged=(4, 8), device="cpu")
        want = unstack_layers(jax_make_cache(jcfg, 2, 100, jnp.float32,
                                             paged=(4, 8)), jcfg)
        assert [{k: tuple(t.shape) for k, t in g.items()} for g in got] \
            == [{k: w[k].shape for k in w} for w in want], name
