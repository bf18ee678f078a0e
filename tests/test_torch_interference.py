"""The port's interference predictor (``repro_torch.core.interference``)
against the reference (``repro.core.interference``), on the CPU.

Adam first: fed the same gradients, ``torch.optim.Adam`` and the
reference's ``repro.train.optimizer.adam`` (bias-corrected moments,
``eps`` added to ``sqrt(v_hat)``) keep every parameter within 1e-6 of
each other over 40 steps (measured 7.2e-7 on parameters of magnitude up
to 4). The two round their step differently (``sqrt(v) / sqrt(1 -
b2^t)`` against ``sqrt(v / (1 - b2^t))``, ``lr / bc1`` applied first or
last), so they are not bit-equal.

One training step at a time, the port re-synced to the reference's
weights and Adam moments before each step and fed the same standardised
inputs, the two agree to 1e-5 relative (measured 7.4e-6 on the
predictions, 4.4e-7 on the loss, over the 32 steps of the online path):
XLA's and torch's CPU matmuls sum the gradients in different orders.
Left free, those differences compound over the steps (3.0e-5 at the
worst step of the same path). So with the reference's weights bridged in
(``bridge.interference_from_jax``) and the same observe/fit_step
sequence, end to end, the two predictors must agree to TOL = 5e-5
relative (measured 1.7e-5 after one fit_step of 8 Adam steps, 2.0e-5
after four, 2.4e-5 after one at batch 64). The feature helpers are
copies and must be equal. The
reference's own tests (tests/test_interference.py:50-65) are mirrored on
the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_config as jax_get_config
from repro.core import interference as jint
from repro.train.optimizer import adam, apply_updates
from repro_torch.config import get_config
from repro_torch.core import interference as tint
from repro_torch.models.bridge import interference_from_jax

TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nonlinear_dataset(n=64, seed=1):
    """The reference test's saturating, knee-shaped latency surface."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        mem_avail = rng.uniform(1, 8)
        m_c = rng.integers(1, 9)
        b = 2 ** rng.integers(0, 8)
        gflops = rng.uniform(0.1, 3.5)
        feats = tint.interference_features(mem_avail, 0.3 + 0.05 * m_c, 0.5,
                                           m_c, b, gflops, 0.1 * m_c * b / 8)
        eff = 0.5 * b / (b + 1.5)
        util = min(1.0, m_c * eff)
        lat = gflops * b * m_c / (0.5 * util)
        pressure = (0.1 * m_c * b / 8) / mem_avail
        if pressure > 0.5:
            lat *= 1 + 4 * (pressure - 0.5) ** 2 * m_c
        X.append(feats)
        y.append(lat / 1000.0)
    return np.stack(X), np.asarray(y)


def test_torch_adam_is_the_reference_adam():
    """Same gradients in, parameters within 2 ulp out, over 40 steps with
    gradients from 1e-9 to 1 (the range where ``eps`` matters)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((7, 128)).astype(np.float32)
    opt = adam(3e-3)
    params, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tp], lr=3e-3)
    for _ in range(40):
        g = (rng.standard_normal(p0.shape)
             * 10.0 ** rng.integers(-9, 1, p0.shape)).astype(np.float32)
        upd, state = opt.update(jnp.asarray(g), state, params)
        params = apply_updates(params, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    want = np.asarray(params)
    got = tp.detach().numpy()
    # the steps moved the parameters by up to 0.12; the two optimizers'
    # roundings leave them within 1e-6 (a misplaced eps or a missing bias
    # correction changes a step by 1e-3 or more)
    assert np.abs(want - p0).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pair(batch_size=16, lr=1e-3):
    ref = jint.NNInterferencePredictor(lr=lr, batch_size=batch_size)
    port = tint.NNInterferencePredictor(lr=lr, batch_size=batch_size,
                                        device="cpu")
    port.load_net(interference_from_jax(
        jax.tree.map(np.asarray, ref.state.net)))
    return ref, port


def test_bridged_predictor_matches_after_online_training():
    """The same observe sequence (four fit_steps of eight Adam steps
    each) leaves both nets predicting the same latencies."""
    ref, port = _pair()
    X, y = _nonlinear_dataset()
    for x, t in zip(X, y):
        ref.observe(x, t)
        port.observe(x, t)
    np.testing.assert_allclose(port._mu, ref._mu, rtol=TOL)
    np.testing.assert_allclose(port._var, ref._var, rtol=TOL)
    got = np.array([port.predict(x) for x in X])
    want = np.array([ref.predict(x) for x in X])
    np.testing.assert_allclose(got, want, rtol=TOL)
    for (name, p), layer in zip(
            sorted(port.net.state_dict().items()),
            sorted(interference_from_jax(jax.tree.map(
                np.asarray, ref.state.net)).items())):
        np.testing.assert_allclose(p.numpy(), layer[1].numpy(), rtol=TOL,
                                   atol=5e-6, err_msg=name)


def _sync(port, ref):
    """The reference's weights and Adam state into the port's net and
    optimizer."""
    net = jax.tree.map(np.asarray, ref.state.net)
    port.load_net(interference_from_jax(net))
    st = ref.state.opt
    mu, nu = (interference_from_jax(jax.tree.map(np.asarray, t))
              for t in (st.mu, st.nu))
    for name, p in port.net.named_parameters():
        s = port.opt.state[p]
        if not s:
            return  # no step taken yet: both start from zero moments
        s["exp_avg"].copy_(mu[name])
        s["exp_avg_sq"].copy_(nu[name])
        s["step"].fill_(float(np.asarray(st.step)))


def test_each_step_agrees_to_1e5_on_the_same_standardised_inputs():
    """Why the end-to-end TOL is 5e-5: the online path of
    test_bridged_predictor_matches_after_online_training, one Adam step
    at a time, with the port re-synced to the reference's weights and
    Adam moments before every step. Fed the same standardised inputs,
    each step's loss and the predictions after it agree to 1e-5
    (relative); only the 32 steps compounded leave the 2e-5 seen end to
    end."""
    ref, port = _pair()
    X, y = _nonlinear_dataset()
    worst = 0.0
    for lo in range(0, len(X), ref.batch_size):
        xb = X[lo:lo + ref.batch_size]
        ref._update_stats(xb)
        port._update_stats(xb)
        np.testing.assert_array_equal(port._mu, ref._mu)
        x = ref._norm(xb).astype(np.float32)
        t = np.log(y[lo:lo + ref.batch_size]).astype(np.float32)
        for _ in range(8):
            _sync(port, ref)
            ref.state, l_ref = jint._pred_update(
                ref.state, jnp.asarray(x), jnp.asarray(t), ref.lr)
            l_port = port._train(torch.from_numpy(x), torch.from_numpy(t), 1)
            assert l_port == pytest.approx(float(l_ref), rel=1e-5)
            got = np.array([port.predict(v) for v in X])
            want = np.array([ref.predict(v) for v in X])
            np.testing.assert_allclose(got, want, rtol=1e-5)
            worst = max(worst, float(np.max(np.abs(got / want - 1))))
    assert worst > 0.0  # the two are not bit-equal: the rounding is real


def test_bridged_predictor_matches_after_fit():
    """Offline fit (the Fig.-13 protocol's entry point) and an explicit
    fit_step on a partial batch: same losses, same predictions."""
    ref, port = _pair(batch_size=64, lr=3e-3)
    X, y = _nonlinear_dataset(48, seed=3)
    l_ref = ref.fit(X[:32], y[:32], epochs=20)
    l_port = port.fit(X[:32], y[:32], epochs=20)
    assert l_port == pytest.approx(l_ref, rel=TOL)
    for x, t in zip(X[32:], y[32:]):
        ref.observe(x, t)
        port.observe(x, t)
    assert port.fit_step() == pytest.approx(ref.fit_step(), rel=TOL)
    assert port.fit_step() == ref.fit_step() == 0.0  # nothing buffered
    np.testing.assert_allclose([port.predict(x) for x in X],
                               [ref.predict(x) for x in X], rtol=TOL)


def test_linear_predictor_matches():
    X, y = _nonlinear_dataset(40, seed=4)
    ref, port = jint.LinearInterferencePredictor(), \
        tint.LinearInterferencePredictor()
    assert port.fit(X, y) == pytest.approx(ref.fit(X, y), rel=1e-6)
    np.testing.assert_allclose([port.predict(x) for x in X],
                               [ref.predict(x) for x in X], rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "arctic-480b"])
def test_engine_features_equal(arch):
    """The pool's feature vector from a config: equal to the reference's
    for dense, recurrent and MoE configs (active vs total parameters)."""
    for m_c, b, total in ((1, 1, 1), (2, 4, 3), (4, 2, 8)):
        np.testing.assert_array_equal(
            tint.engine_features(get_config(arch), m_c, b, total),
            jint.engine_features(jax_get_config(arch), m_c, b, total))


def test_online_observe_path():
    """tests/test_interference.py::test_online_observe_path on the port."""
    nn = tint.NNInterferencePredictor(batch_size=16, device="cpu")
    X, y = _nonlinear_dataset(64, seed=1)
    for x, t in zip(X, y):
        nn.observe(x, t)
    preds = np.array([nn.predict(x) for x in X])
    assert np.all(np.isfinite(preds))
    assert np.median(np.abs(np.log(preds) - np.log(y))) < 2.0


def test_feature_vector_shape():
    f = tint.interference_features(4.0, 0.3, 0.5, 2, 8, 1.8, 0.2)
    assert f.shape == (7,)
    assert np.isfinite(f).all()
    np.testing.assert_array_equal(
        f, jint.interference_features(4.0, 0.3, 0.5, 2, 8, 1.8, 0.2))


def test_predictor_defaults_to_the_gpu(monkeypatch):
    """No CPU fallback: without a GPU the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tint.NNInterferencePredictor()
