"""The paper's edge networks (``repro_torch.models.cnn``) against the
reference's ``repro.models.cnn`` on the CPU, with the reference's weights
bridged in: each of the five convolutional nets on seeded numpy images
(an even and an odd size, so "SAME" padding's after-side extra row is
exercised at every stride), and TinyBERT on seeded tokens. Tolerance:
outputs atol 1e-4 (fp32 convolutions summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.models import cnn

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _ints(tree):
    """The jitted init's 0-d ``stride`` arrays back to Python ints."""
    if isinstance(tree, dict):
        return {k: int(v) if k == "stride" else _ints(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ints(v) for v in tree)
    return tree


def _jax_params(name, n_classes=10):
    """The reference net's params (jitted init: its eager form dispatches
    hundreds of random ops one by one), cached per init function."""
    jinit = jcnn.EDGE_NETS[name][0]
    if jinit not in _PARAMS:
        _PARAMS[jinit] = _ints(jax.jit(lambda k: jinit(
            k, n_classes=n_classes))(jax.random.PRNGKey(3)))
    return _PARAMS[jinit]


def test_edge_net_registry_is_the_references():
    assert sorted(cnn.EDGE_NETS) == sorted(jcnn.EDGE_NETS)


@pytest.mark.parametrize("shape", [(2, 40, 40), (1, 29, 29)])
@pytest.mark.parametrize("name", sorted(jcnn.EDGE_NETS))
def test_edge_net_matches_the_reference(name, shape):
    B, H, W = shape
    japply = jcnn.EDGE_NETS[name][1]
    _, apply = cnn.EDGE_NETS[name]
    jp = _jax_params(name)
    p = cnn.edge_params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(B * H).standard_normal(
        (B, H, W, 3)).astype(np.float32)
    # jit with the params closed over: strides stay Python ints
    want = np.asarray(jax.jit(lambda xs: japply(jp, xs))(jnp.asarray(x)))
    got = apply(p, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(jcnn.EDGE_NETS))
def test_port_init_has_the_bridged_layout(name):
    """The port's own init draws the params the bridge produces: the same
    keys, shapes and strides."""
    init, apply = cnn.EDGE_NETS[name]
    bridged = cnn.edge_params_from_jax(jax.tree.map(np.asarray,
                                                    _jax_params(name)))
    own = init(seed=0, n_classes=10, device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return tree if isinstance(tree, int) else tuple(tree.shape)

    assert layout(own) == layout(bridged)
    out = apply(own, torch.zeros(1, 32, 32, 3))
    assert torch.isfinite(out).all()


def test_tinybert_matches_the_reference():
    """TinyBERT (the decoder trunk, causal, LayerNorm and GELU) on the
    reference's weights: class logits to 1e-4."""
    jpc = jcnn.tinybert_init(jax.random.PRNGKey(1), vocab=500, d=64,
                             n_layers=2, n_heads=2, n_classes=12)
    pc = cnn.tinybert_params_from_jax(jax.tree.map(np.asarray, jpc[0]),
                                      jpc[1])
    toks = np.random.default_rng(2).integers(0, 500, (3, 14)).astype(
        np.int32)
    want = np.asarray(jcnn.tinybert_apply(jpc, jnp.asarray(toks)))
    got = cnn.tinybert_apply(pc, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    own, cfg = cnn.tinybert_init(seed=0, vocab=500, d=64, n_layers=2,
                                 n_classes=12, device="cpu")
    assert cfg == pc[1]
    assert cnn.tinybert_apply((own, cfg), torch.from_numpy(toks)).shape \
        == (3, 12)
