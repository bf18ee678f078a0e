"""Training through the port's kernels, on the CPU: each kernel's
``torch.autograd.Function`` against autograd of its plain version, the
guard on raw launches, ``Model.loss`` with its gradients for five of the
ten reduced assigned archs (the other five are in
``test_torch_substrate.py``), ``remat`` against none, and the trainer's
first 10 losses against the reference trainer's from bridged params.

On the CPU each Function's forward is the plain version and its
backward the same code the card runs (flash's torch-op softmax
gradient, the reversed RG-LRU scan, ``moe_matmul`` twice, RWKV-6's
reverse pass), so these tests exercise every backward. Tolerances:
Function gradients atol 1e-5 (fp32, another summation order); the
loss 1e-5 and each gradient leaf 1e-4 relative (``test_torch_substrate``);
remat 1e-6 (the same ops recomputed); trainer losses 1e-4 relative over
10 Adam steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_reduced_config as jax_reduced
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.common.tree import flatten_with_paths, tree_leaves
from repro_torch.config.base import ModelConfig
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import moe_matmul as mm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.train.train_state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_arch_smoke import make_batch
from test_torch_substrate import _bridged, loss_and_grads_match

FN_ATOL = 1e-5
REMAT_ATOL = 1e-6
TRAIN_RTOL = 1e-4
ARCHS = ("llama4-maverick-400b-a17b", "starcoder2-15b", "qwen2-vl-7b",
         "chatglm3-6b", "yi-34b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shapes, seed, positive=()):
    rng = np.random.default_rng(seed)
    out = []
    for i, shp in enumerate(shapes):
        a = rng.standard_normal(shp)
        if i in positive:  # decays in (0.05, 0.95)
            a = 0.05 + 0.9 * rng.random(shp)
        out.append(torch.tensor(a, dtype=torch.float32))
    return out


def _grads_vs_plain(fn, plain, inputs, seed=0):
    """(outputs, grads) of ``fn`` and of ``plain`` under the same seeded
    output cotangents; asserts the Function's grads match."""
    def run(f):
        ins = [t.clone().requires_grad_() for t in inputs]
        outs = f(*ins)
        return ins, (outs if isinstance(outs, tuple) else (outs,))

    ins, outs = run(fn)
    rng = np.random.default_rng(seed + 100)
    cots = [torch.tensor(rng.standard_normal(tuple(o.shape)),
                         dtype=torch.float32) for o in outs]
    got = torch.autograd.grad(outs, ins, cots)
    ins2, outs2 = run(plain)
    want = torch.autograd.grad(outs2, ins2, cots)
    for o, o2 in zip(outs, outs2):
        torch.testing.assert_close(o.detach(), o2.detach(), rtol=0, atol=0)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=FN_ATOL, atol=FN_ATOL,
                                   msg=f"input {i}")
    return outs, got


# ====================================================== the Functions
FLASH_CASES = {
    # (B, S, T, H, KV, hd, causal, window)
    "causal-gqa": (2, 40, 40, 4, 2, 8, True, None),
    "window": (1, 70, 70, 4, 1, 16, True, 9),
    "noncausal-cross": (2, 24, 13, 2, 2, 8, False, None),
    # past BWD_ROWS: the backward's second block of query rows
    "causal-two-blocks": (1, 600, 600, 2, 1, 8, True, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_function_matches_plain_autograd(case):
    B, S, T, H, KV, hd, causal, window = FLASH_CASES[case]
    q, k, v = _inputs([(B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)], 1)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    outs, _ = _grads_vs_plain(
        lambda q, k, v: fl.flash_attention(q, k, v, **kw),
        lambda q, k, v: fl.flash_attention_plain(q, k, v, **kw), [q, k, v])
    assert type(outs[0].grad_fn).__name__ == "FlashAttentionBackward"


@pytest.mark.parametrize("S", [1, 37])
def test_rglru_reversed_scan_matches_plain_autograd(S):
    a, x, h0 = _inputs([(2, S, 6), (2, S, 6), (2, 6)], 2, positive=(0,))
    outs, _ = _grads_vs_plain(rg.rglru_scan, rg.rglru_scan_plain,
                              [a, x, h0])
    assert type(outs[0].grad_fn).__name__ == "RGLRUScanBackward"


def test_rglru_backward_is_one_forward_scan():
    """The backward runs the forward scan once more (the kernel's one
    launch on the card), over reversed time."""
    a, x, h0 = [t.requires_grad_() for t in _inputs(
        [(1, 9, 4), (1, 9, 4), (1, 4)], 3, positive=(0,))]
    calls = []
    launch = rg.rglru_scan_launch
    try:
        rg.rglru_scan_launch = lambda *t: calls.append(t) or launch(*t)
        hs, hf = rg.rglru_scan(a, x, h0)
        (hs.sum() + hf.sum()).backward()
    finally:
        rg.rglru_scan_launch = launch
    assert len(calls) == 2
    rev_a = calls[1][0]
    torch.testing.assert_close(rev_a[0, 1:], a.detach()[0, 1:].flip(0))
    assert bool((rev_a[:, 0] == 1).all())


def test_moe_matmul_function_is_the_kernel_twice():
    x, w = _inputs([(3, 8, 12), (3, 12, 16)], 4)
    calls = []
    launch = mm.moe_matmul_launch
    try:
        mm.moe_matmul_launch = lambda *t: calls.append(
            tuple(u.shape for u in t)) or launch(*t)
        outs, _ = _grads_vs_plain(mm.moe_matmul, mm.moe_matmul_plain,
                                  [x, w])
    finally:
        mm.moe_matmul_launch = launch
    assert type(outs[0].grad_fn).__name__ == "MoeMatmulBackward"
    # forward, then dx = dy @ w^T and dw = x^T @ dy
    assert calls == [((3, 8, 12), (3, 12, 16)), ((3, 8, 16), (3, 16, 12)),
                     ((3, 12, 8), (3, 8, 16))]


def test_rwkv6_function_matches_plain_autograd():
    """Every input's gradient, the bonus ``u`` and the carried state
    included."""
    B, S, H, hd = 2, 11, 3, 8
    r, k, v, w, u, st = _inputs([(B, S, H, hd)] * 4 + [(H, hd),
                                                      (B, H, hd, hd)],
                                5, positive=(3,))
    outs, grads = _grads_vs_plain(rk.rwkv6_scan, rk.rwkv6_scan_plain,
                                  [r, k, v, w, u, st])
    assert type(outs[0].grad_fn).__name__ == "RWKV6ScanBackward"
    assert float(grads[4].abs().max()) > 0 and \
        float(grads[5].abs().max()) > 0


RAW = {
    "flash_attention": (lambda *t: fl.flash_attention_launch(
        *t, scale=0.5), [(1, 4, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)]),
    "rglru_scan": (rg.rglru_scan_launch, [(1, 4, 3), (1, 4, 3), (1, 3)]),
    "rwkv6_scan": (rk.rwkv6_scan_launch, [(1, 3, 2, 4)] * 4
                   + [(2, 4), (1, 2, 4, 4)]),
    "moe_matmul": (mm.moe_matmul_launch, [(2, 3, 4), (2, 4, 8)]),
}


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_launch_under_grad_raises(name):
    """A raw launch would return a tensor with no grad_fn, so every
    weight upstream would train on a zero gradient: it refuses, on the
    CPU as on the card. Without grad (serving) it runs."""
    fn, shapes = RAW[name]
    ins = _inputs(shapes, 6, positive=(0,) if name == "rglru_scan" else ())
    fn(*ins)
    with torch.no_grad():
        fn(*[t.requires_grad_() for t in ins])
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*ins)


# ====================================================== Model.loss
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    loss_and_grads_match(arch)


def test_chunked_cross_entropy_matches_the_reference():
    """S = 512, two chunks of ``LOSS_CHUNK``: the mean of the chunks'
    means, each chunk's logits recomputed in the backward."""
    cfg, jm, jp, tcfg, tp = _bridged("qwen3-0.6b")
    batch = make_batch(cfg, B=1, S=512, seed=2)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = build_model(tcfg, remat=False).loss(
        tp, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves)
    gref = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    for (path, r), g in zip(flatten_with_paths(gref), tg):
        err = float((g - r).abs().max()) / float(r.abs().max())
        assert err <= 1e-4, (path, err)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "arctic-480b"])
def test_remat_equals_no_remat(arch):
    """``remat=True`` recomputes each layer in the backward: the same loss
    and gradients (dense, hybrid recurrent with a window, MoE)."""
    cfg, _, _, tcfg, tp = _bridged(arch)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v))
          for k, v in make_batch(cfg).items()}
    out = []
    for remat in (False, True):
        loss = build_model(tcfg, remat=remat).loss(tp, tb)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert build_model(tcfg).remat  # the reference's default
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0,
                               atol=REMAT_ATOL)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=REMAT_ATOL)


# ====================================================== the trainer
def test_trainer_tracks_the_references_losses():
    """10 steps of the port's trainer from the reference trainer's params
    (bridged) on the same pipeline: each step's loss to 1e-4 relative,
    and the params after them."""
    cfg = jax_reduced("qwen3-0.6b")
    kw = dict(batch=2, seq_len=64, steps=10, lr=3e-3, warmup=3,
              log_every=1000)
    jtr = JaxTrainer(cfg, JaxTrainerConfig(**kw))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    ttr = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    ttr.state = TrainState.create(Trainer.trainable(params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params), tcfg)), ttr.opt)
    jpipe, tpipe = jtr.data(), ttr.data()
    for step in range(kw["steps"]):
        jraw, traw = jpipe.sample_batch(), tpipe.sample_batch()
        np.testing.assert_array_equal(traw["tokens"], jraw["tokens"])
        jtr.state, jl = jtr._step(jtr.state, {k: jnp.asarray(v)
                                              for k, v in jraw.items()})
        ttr.state, tl = ttr._step(ttr.state, ttr.to_batch(traw))
        np.testing.assert_allclose(float(tl), float(jl), rtol=TRAIN_RTOL,
                                   err_msg=f"step {step}")
    assert int(ttr.state.step) == int(jtr.state.step) == kw["steps"]
    want = params_from_jax(jax.tree.map(np.asarray, jtr.state.params),
                           tcfg)
    for (path, a), (_, b) in zip(flatten_with_paths(want),
                                 flatten_with_paths(ttr.state.params)):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(),
                                   atol=1e-4, rtol=0, err_msg=path)
