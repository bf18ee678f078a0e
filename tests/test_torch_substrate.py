"""The port's training substrate (``repro_torch.common``,
``repro_torch.train``) against the JAX package's, on the CPU.

First the reference's ``tests/test_substrate.py`` mirrored on the port,
then the port held against the reference on the same seeded numpy
inputs: the optimizers step for step over 20 steps (params to 1e-6:
float32 updates of order 0.1 per step, summed in another order), the
schedule to 1e-7 relative (both float32), trees and types on one tree,
checkpoints read across the packages (keys, values and metadata equal),
the token pipeline bit for bit (both numpy), the launcher on the CPU,
and ``Model.loss`` with its gradients for five of the ten reduced
assigned archs (the other five are in ``test_torch_train.py``).
"""
import dataclasses
import math
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.common import tree as jtree
from repro.common import types as jtypes
from repro.config import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.data import TokenPipeline as JaxPipeline
from repro_torch.common import tree as ttree
from repro_torch.common import types as ttypes
from repro_torch.common.tree import global_norm
from repro_torch.config.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.train.checkpoint import load_checkpoint, restore_like, \
    save_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import (adam, apply_updates, chain_clip,
                                         constant, sgd, warmup_cosine)
from test_arch_smoke import make_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_ATOL = 1e-6
#: Model.loss to 1e-5 relative; each gradient leaf's max |diff| over its
#: max |reference| to 1e-4 (fp32 sums in another order, over a few layers
#: and a vocabulary projection; RWKV-6's bonus ``u`` sums a product over
#: every (step, key, value) and is the worst leaf)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
#: this file's half of the ten assigned archs
ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "rwkv6-3b", "arctic-480b",
         "seamless-m4t-large-v2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ================================================ the reference's tests
def _quadratic(params):
    return torch.sum(torch.square(params["w"] - 3.0)) + \
        torch.sum(torch.square(params["b"] + 1.0))


def _grad(params):
    ps = {k: v.detach().requires_grad_() for k, v in params.items()}
    g = torch.autograd.grad(_quadratic(ps), [ps["w"], ps["b"]])
    return {"w": g[0], "b": g[1]}


@pytest.mark.parametrize("opt_fn", [
    lambda: sgd(0.1), lambda: sgd(0.05, momentum=0.9), lambda: adam(0.1),
    lambda: adam(0.1, weight_decay=1e-4),
])
def test_optimizers_minimize_quadratic(opt_fn):
    opt = opt_fn()
    params = {"w": torch.zeros(4), "b": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(300):
        updates, state = opt.update(_grad(params), state, params)
        params = apply_updates(params, updates)
    assert float(_quadratic(params)) < 1e-2


def test_clipping_bounds_update_norm():
    opt = chain_clip(sgd(1.0), max_norm=0.5)
    params = {"w": torch.zeros(8)}
    state = opt.init(params)
    grads = {"w": torch.full((8,), 100.0)}
    updates, _ = opt.update(grads, state, params)
    assert float(global_norm(updates)) <= 0.5 + 1e-5


def test_warmup_cosine_schedule_shape():
    sched = warmup_cosine(1.0, warmup=10, total=100)
    v0, v10, v100 = sched(0), sched(10), sched(100)
    assert v0 < 0.2
    assert v10 == pytest.approx(1.0, abs=0.1)
    assert v100 < v10


@given(lr=st.floats(1e-4, 1e-1), steps=st.integers(1, 20))
@settings(max_examples=20, deadline=None)
def test_adam_update_is_finite(lr, steps):
    opt = adam(lr)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    for _ in range(steps):
        updates, state = opt.update({"w": torch.ones(4)}, state, params)
        params = apply_updates(params, updates)
    assert bool(torch.isfinite(params["w"]).all())


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "c": [torch.ones(2, dtype=torch.int32), torch.zeros(3)]}
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, tree, {"step": 7})
    loaded = load_checkpoint(path)
    assert loaded["__meta__"]["step"] == 7
    restored = restore_like(tree, loaded)
    for a, b in zip(ttree.tree_leaves(tree), ttree.tree_leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        restore_like({"w": torch.ones((3, 2))}, load_checkpoint(path))


def test_pipeline_deterministic():
    a = TokenPipeline(512, 32, 4, seed=3).sample_batch()
    b = TokenPipeline(512, 32, 4, seed=3).sample_batch()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    batch = TokenPipeline(512, 32, 4, seed=0).sample_batch()
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


def test_pipeline_has_learnable_structure():
    """Markov stream must be compressible below the uniform entropy."""
    from collections import Counter, defaultdict

    toks = TokenPipeline(256, 64, 8, seed=1, order=1).sample_batch()[
        "tokens"]
    ctx_next = defaultdict(Counter)
    for row in toks:
        for t in range(1, len(row)):
            ctx_next[(row[t - 1],)][row[t]] += 1
    repeated = [c for c in ctx_next.values() if sum(c.values()) >= 3]
    assert repeated
    agreement = np.mean([c.most_common(1)[0][1] / sum(c.values())
                         for c in repeated])
    assert agreement > 0.4  # uniform would be ~1/256


@pytest.mark.slow
def test_trainer_reduces_loss():
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                      n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=256)
    tr = Trainer(cfg, TrainerConfig(batch=8, seq_len=64, steps=120,
                                    lr=3e-3, log_every=1000), device="cpu")
    stats = tr.run(log=lambda *_: None)
    assert stats["final_loss"] < stats["first_loss"] - 0.5
    assert stats["final_loss"] < math.log(256)


# ================================================ against the reference
def _decay_mask(path):
    return path.split("/")[-1] not in ("scale", "bias")


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adam": lambda m: m.adam(0.05),
    "adamw-mask": lambda m: m.adamw(m.warmup_cosine(0.05, 5, 20),
                                    weight_decay=0.1, mask=_decay_mask),
    "adamw-nomask": lambda m: m.adamw(0.05, weight_decay=0.1),
    "clip-adamw": lambda m: m.chain_clip(m.adam(
        m.warmup_cosine(0.05, 5, 20), weight_decay=0.01,
        mask=_decay_mask), 1.0),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_the_reference(name):
    """20 steps on the same params and seeded grads (large enough that
    the clipped variant clips): params and moments after every step."""
    import repro_torch.train.optimizer as topt

    rng = np.random.default_rng(3)
    p_np = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layer": {"b": rng.standard_normal(3).astype(np.float32),
                      "norm": {"scale": np.ones(3, np.float32)}}}
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _t(p_np)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(20):
        g_np = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 2).astype(np.float32),
            p_np)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(_t(g_np), ts, tp)
        tp = apply_updates(tp, tu)
        for (k, a), (k2, b) in zip(jtree.flatten_with_paths(jp),
                                   ttree.flatten_with_paths(tp)):
            assert k == k2
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=OPT_ATOL, rtol=0, err_msg=k)
    assert int(ts.step) == int(js.step) == 20
    for (k, a), (k2, b) in zip(jtree.flatten_with_paths(js),
                               ttree.flatten_with_paths(ts)):
        assert k == k2
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=OPT_ATOL, rtol=1e-5, err_msg=k)


def test_schedules_match_the_reference():
    for jsched, tsched in ((jopt.warmup_cosine(3e-4, 50, 300),
                            warmup_cosine(3e-4, 50, 300)),
                           (jopt.warmup_cosine(1.0, 10, 100, floor=0.2),
                            warmup_cosine(1.0, 10, 100, floor=0.2)),
                           (jopt.constant(0.01), constant(0.01))):
        for step in (0, 1, 9, 10, 11, 49, 50, 51, 120, 299, 300, 400):
            want = float(jsched(jnp.asarray(step, jnp.int32)))
            assert tsched(step) == pytest.approx(want, rel=1e-7, abs=0)


class _Pair(NamedTuple):
    step: np.ndarray
    mom: dict


def _sample_tree():
    rng = np.random.default_rng(0)
    return {"emb": rng.standard_normal((5, 3)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((3, 2)).astype(np.float32),
                        "norm": {"scale": np.ones(2, np.float32)}}
                       for _ in range(2)],
            "opt": _Pair(np.asarray(4, np.int32),
                         {"b": rng.standard_normal(7).astype(np.float32)}),
            "none": None}


def test_trees_match_the_reference():
    tree = _sample_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _t(tree)
    jflat, tflat = jtree.flatten_with_paths(jt), ttree.flatten_with_paths(tt)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jn, tn = jtree.named_dict(jt), ttree.named_dict(tt)
    assert list(jn) == list(tn)
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])
    np.testing.assert_allclose(float(global_norm(tt)),
                               float(jtree.global_norm(jt)), rtol=1e-6)
    jm = jtree.tree_map_with_path(lambda k, x: k.count("/") * x, jt)
    tm = ttree.tree_map_with_path(lambda k, x: k.count("/") * x, tt)
    for a, b in zip(jax.tree.leaves(jm), ttree.tree_leaves(tm)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for fn in ("tree_zeros_like",):
        for a, b in zip(jax.tree.leaves(getattr(jtree, fn)(jt)),
                        ttree.tree_leaves(getattr(ttree, fn)(tt))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jtree.tree_add(jt, jt)),
                    ttree.tree_leaves(ttree.tree_add(tt, tt))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jtree.tree_scale(jt, 0.5)),
                    ttree.tree_leaves(ttree.tree_scale(tt, 0.5))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jtree.to_numpy(jt)),
                    ttree.tree_leaves(ttree.to_numpy(tt))):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(b, a)
    assert ttree.tree_size_report(tt, top=3) == \
        jtree.tree_size_report(jt, top=3)


def test_types_match_the_reference():
    tree = _sample_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _t(tree)
    assert ttypes.param_count(tt) == jtypes.param_count(jt)
    assert ttypes.param_bytes(tt) == jtypes.param_bytes(jt)
    for n in (0, 999, 1000, 1_234_567, 7.5e9, 2e12):
        assert ttypes.fmt_count(n) == jtypes.fmt_count(n)
        assert ttypes.fmt_bytes(n) == jtypes.fmt_bytes(n)
    jc = jtypes.cast_tree(jt, jnp.bfloat16)
    tc = ttypes.cast_tree(tt, torch.bfloat16)
    for a, b in zip(jax.tree.leaves(jc), ttree.tree_leaves(tc)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    for a, b in zip(jax.tree.leaves(jtypes.shape_dtype(jt)),
                    ttree.tree_leaves(ttypes.shape_dtype(tt))):
        assert tuple(b.shape) == tuple(a.shape)
        assert b.device.type == "meta"
    assert ttypes.merge_dicts({"a": 1}, {"b": 2, "a": 3}) == \
        jtypes.merge_dicts({"a": 1}, {"b": 2, "a": 3})
    ttypes.assert_finite("ok", tt["emb"])
    with pytest.raises(FloatingPointError):
        ttypes.assert_finite("bad", torch.tensor([1.0, float("nan")]))


def _same_loaded(a, b):
    assert a["__meta__"] == b["__meta__"]
    fa = dict(jtree.flatten_with_paths(
        {k: v for k, v in a.items() if k != "__meta__"}))
    fb = dict(jtree.flatten_with_paths(
        {k: v for k, v in b.items() if k != "__meta__"}))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_checkpoints_cross_the_packages(tmp_path):
    """A file either package writes is the same dict of arrays to both
    readers, and each restores it onto its own tree."""
    tree = _sample_tree()
    meta = {"steps": 3, "final_loss": 1.25}
    port_path = str(tmp_path / "port.npz")
    ref_path = str(tmp_path / "ref.npz")
    save_checkpoint(port_path, _t(tree), meta)
    jckpt.save_checkpoint(ref_path, jax.tree.map(jnp.asarray, tree), meta)
    for path in (port_path, ref_path):
        _same_loaded(load_checkpoint(path), jckpt.load_checkpoint(path))
    _same_loaded(load_checkpoint(port_path), load_checkpoint(ref_path))
    restored = restore_like(_t(tree), load_checkpoint(ref_path))
    for a, b in zip(jax.tree.leaves(tree), ttree.tree_leaves(restored)):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), a)
    jrestored = jckpt.restore_like(jax.tree.map(jnp.asarray, tree),
                                   jckpt.load_checkpoint(port_path))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jrestored)):
        np.testing.assert_array_equal(np.asarray(b), a)


@pytest.mark.parametrize("kw", [dict(), dict(order=2, rank=1, world=2)])
def test_pipeline_batches_are_the_references(kw):
    a = TokenPipeline(300, 48, 4, seed=5, **kw)
    b = JaxPipeline(300, 48, 4, seed=5, **kw)
    for _ in range(3):
        x, y = a.sample_batch(), b.sample_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    # the prefetching iterator yields the same stream
    it_a, it_b = iter(TokenPipeline(300, 16, 2, seed=1)), \
        iter(JaxPipeline(300, 16, 2, seed=1))
    for _ in range(3):
        np.testing.assert_array_equal(next(it_a)["tokens"],
                                      next(it_b)["tokens"])
    it_a.close()
    it_b.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_launch_train_cli_on_the_cpu_and_its_refusal(tmp_path):
    """The CLI trains on the CPU when asked, writes a checkpoint the
    reference reads, and refuses to run without a GPU otherwise."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-0.6b", "--reduced", "--steps", "3"]
    ckpt = str(tmp_path / "lm.npz")
    out = subprocess.run(cmd + ["--device", "cpu", "--ckpt", ckpt],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "final loss: " in out.stdout
    assert out.stdout.count("step ") == 2  # steps 0 and 2 log
    loaded = jckpt.load_checkpoint(ckpt)
    assert loaded["__meta__"]["steps"] == 3
    cfg = jax_reduced("qwen3-0.6b")
    assert loaded["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert len(loaded["layers"]) == cfg.n_layers
    out = subprocess.run(cmd, env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


# ================================================ Model.loss and grads
def _bridged(arch):
    cfg = jax_reduced(arch)
    jm = jax_build_model(cfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return cfg, jm, jp, tcfg, tp


def loss_and_grads_match(arch, remat=False):
    """The port's ``Model.loss`` and ``torch.autograd.grad`` against the
    reference's ``loss`` and ``jax.grad`` on bridged params and
    ``make_batch``'s inputs. Returns the worst leaf's relative error."""
    cfg, jm, jp, tcfg, tp = _bridged(arch)
    batch = make_batch(cfg)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    leaves = ttree.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tl = build_model(tcfg, remat=remat).loss(tp, tb)
    assert tl.shape == () and tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    tg = torch.autograd.grad(tl, leaves)
    gref = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    worst = 0.0
    for (path, r), g in zip(ttree.flatten_with_paths(gref), tg):
        r, g = r.numpy(), g.numpy()
        assert g.shape == r.shape, path
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= GRAD_RTOL, (arch, path, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    loss_and_grads_match(arch)
