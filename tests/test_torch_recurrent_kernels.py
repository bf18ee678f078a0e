"""The port's recurrent scans (``rglru_scan``, ``rwkv6_scan``), on the CPU:
their plain PyTorch versions held against the pure-jnp oracles in
``repro.kernels.ref`` and the JAX Pallas kernels (interpret mode, as
tests/test_kernels.py runs them), on the same numpy inputs, over the
sweeps of tests/test_kernels.py.

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds them against
these plain versions there. Here the wrappers must route CPU tensors to
the plain version without counting a launch, and refuse what the kernels
do not take.

Tolerances (those of tests/test_kernels.py): rwkv6 atol 1e-4 / rtol
1e-3 (an hd-long sum per output, in another order), rglru atol 1e-5 /
rtol 1e-4 (one multiply-add per step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as trk

RWKV_TOL = dict(atol=1e-4, rtol=1e-3)
RGLRU_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rwkv_inputs(rng, B, S, H, hd):
    """The distributions of tests/test_kernels.py::test_rwkv6_scan."""
    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return dict(r=rnd(B, S, H, hd), k=rnd(B, S, H, hd, scale=0.3),
                v=rnd(B, S, H, hd, scale=0.3),
                w=(rng.random((B, S, H, hd)) * 0.5 + 0.4).astype(np.float32),
                u=rnd(H, hd, scale=0.1), state=rnd(B, H, hd, hd, scale=0.1))


def _rglru_inputs(rng, B, S, W):
    """The distributions of tests/test_kernels.py::test_rglru_scan."""
    return dict(a=(rng.random((B, S, W)) * 0.5 + 0.4).astype(np.float32),
                x=(rng.standard_normal((B, S, W)) * 0.3).astype(np.float32),
                h0=(rng.standard_normal((B, W)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 32, 2, 64, 8), (2, 40, 4, 64, 16), (1, 64, 1, 128, 64),
])
def test_rwkv6_scan_plain_matches_reference(B, S, H, hd, chunk):
    """Output and final state against the jnp oracle and the Pallas
    kernel (interpret mode), S off the chunk included."""
    x = _rwkv_inputs(np.random.default_rng(B * S + hd), B, S, H, hd)
    out, s_final = trk.rwkv6_scan(**{n: _t(a) for n, a in x.items()})
    j = {n: jnp.asarray(a) for n, a in x.items()}
    for want_out, want_state in (ref.rwkv6_scan_ref(**j),
                                 ops.rwkv6_scan(**j, chunk=chunk)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   **RWKV_TOL)
        np.testing.assert_allclose(s_final.numpy(), np.asarray(want_state),
                                   **RWKV_TOL)


@pytest.mark.parametrize("B,S,W,chunk,bw", [
    (2, 40, 96, 16, 32), (1, 33, 64, 8, 64), (2, 128, 256, 64, 128),
])
def test_rglru_scan_plain_matches_reference(B, S, W, chunk, bw):
    """Every h_t and the final state against the jnp oracle and the
    Pallas kernel (interpret mode), S and W off the blocks included."""
    x = _rglru_inputs(np.random.default_rng(B * S + W), B, S, W)
    hs, h_final = trg.rglru_scan(**{n: _t(a) for n, a in x.items()})
    j = {n: jnp.asarray(a) for n, a in x.items()}
    for want_hs, want_h in (ref.rglru_scan_ref(j["a"], j["x"], j["h0"]),
                            ops.rglru_scan(j["a"], j["x"], j["h0"],
                                           chunk=chunk, block_w=bw)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs),
                                   **RGLRU_TOL)
        np.testing.assert_allclose(h_final.numpy(), np.asarray(want_h),
                                   **RGLRU_TOL)


def _nan_headed(a: np.ndarray, extra: int = 97) -> torch.Tensor:
    """``a`` as a contiguous tensor at the head of a flat buffer whose
    next ``extra`` floats are NaN: a read past its last element reads
    NaN."""
    buf = torch.full((a.size + extra,), float("nan"))
    buf[:a.size] = _t(a.reshape(-1))
    return buf[:a.size].view(a.shape)


@pytest.mark.parametrize("name", ["rglru", "rwkv6"])
def test_scans_read_nothing_past_their_inputs(name):
    """Every input at the head of a NaN-tailed buffer (a ragged S and W,
    as on the card in chip_smoke.py): outputs stay finite and equal the
    clean run's."""
    rng = np.random.default_rng(7)
    if name == "rglru":
        x = _rglru_inputs(rng, 2, 33, 100)
        fn = trg.rglru_scan
    else:
        x = _rwkv_inputs(rng, 1, 17, 3, 48)
        fn = trk.rwkv6_scan
    clean = fn(**{n: _t(a) for n, a in x.items()})
    poisoned = fn(**{n: _nan_headed(a) for n, a in x.items()})
    for got, want in zip(poisoned, clean):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    g = {n: _t(a) for n, a in _rglru_inputs(rng, 2, 5, 8).items()}
    r = {n: _t(a) for n, a in _rwkv_inputs(rng, 2, 5, 2, 8).items()}
    n0 = (trg.rglru_scan.launches, trk.rwkv6_scan.launches)
    for got, want in ((trg.rglru_scan(**g), trg.rglru_scan_plain(**g)),
                      (trk.rwkv6_scan(**r), trk.rwkv6_scan_plain(**r))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (trg.rglru_scan.launches, trk.rwkv6_scan.launches) == n0
    # S = 0: no step, the state passes through
    hs, h = trg.rglru_scan(g["a"][:, :0], g["x"][:, :0], g["h0"])
    assert hs.shape == (2, 0, 8) and torch.equal(h, g["h0"])
    out, st = trk.rwkv6_scan(*(r[n][:, :0] for n in "rkvw"), r["u"],
                             r["state"])
    assert out.shape == (2, 0, 2, 8) and torch.equal(st, r["state"])


def test_scan_launch_args_are_validated():
    """What the scan kernels take is checked before any launch: float32,
    contiguous, one device, matching shapes; a device with no kernel
    raises too."""
    rng = np.random.default_rng(4)
    g = {n: _t(a) for n, a in _rglru_inputs(rng, 2, 5, 8).items()}
    shapes = {"a": (2, 5, 8), "x": (2, 5, 8), "h0": (2, 8)}
    _build.check_scan_args("t", g, shapes)
    bad = [{**g, "a": g["a"].double()}, {**g, "x": g["x"].transpose(0, 1)},
           {**g, "h0": g["h0"][:1]}]
    for args in bad:
        with pytest.raises(ValueError):
            _build.check_scan_args("t", args, shapes)
    meta = {n: t.to("meta") for n, t in g.items()}
    with pytest.raises(ValueError, match="no kernel"):
        trg.rglru_scan(**meta)
    r = {n: _t(a).to("meta") for n, a in
         _rwkv_inputs(rng, 1, 2, 1, 8).items()}
    with pytest.raises(ValueError, match="no kernel"):
        trk.rwkv6_scan(**r)
