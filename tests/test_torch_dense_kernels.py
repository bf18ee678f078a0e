"""The port's flash attention and dense decode attention, on the CPU: their
plain PyTorch versions held against the JAX Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and the pure-jnp oracles in
``repro.kernels.ref``, on the same numpy inputs, over the sweeps of
tests/test_kernels.py (float32).

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
them against these plain versions there. Here the wrappers must route
CPU tensors to the plain version without counting a launch, and the
launch-argument checks must refuse what the kernels do not take.

Tolerance: fp32 attention outputs, atol = rtol = 1e-5 (the two sides
sum in different orders; nothing else differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flash_all(q, k, v, **kw):
    """(port plain, Pallas interpret, jnp oracle) on the same inputs."""
    scale = q.shape[-1] ** -0.5
    got = tflash.flash_attention(_t(q), _t(k), _t(v), scale=scale,
                                 **kw).numpy()
    pallas = np.asarray(ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        block_q=32, block_k=32, **kw))
    oracle = np.asarray(ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, **kw))
    return got, pallas, oracle


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 2, 2, 64), (2, 96, 4, 2, 64), (1, 128, 8, 1, 128),
    (2, 80, 6, 3, 64)])
def test_flash_plain_matches_pallas_and_ref(B, S, H, KV, hd):
    rng = np.random.default_rng(S + H)
    q, k, v = _rnd(rng, B, S, H, hd), _rnd(rng, B, S, KV, hd), \
        _rnd(rng, B, S, KV, hd)
    got, pallas, oracle = _flash_all(q, k, v)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [8, 33, 64])
def test_flash_plain_window(window):
    rng = np.random.default_rng(window)
    B, S, H, KV, hd = 2, 96, 4, 2, 64
    q, k, v = _rnd(rng, B, S, H, hd), _rnd(rng, B, S, KV, hd), \
        _rnd(rng, B, S, KV, hd)
    got, pallas, oracle = _flash_all(q, k, v, window=window)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


def test_flash_plain_noncausal_padded_and_t_ne_s():
    """Non-causal with S and T off the block size (the Pallas kernel
    masks its T padding), and T != S."""
    rng = np.random.default_rng(11)
    B, S, T, H, KV, hd = 1, 40, 52, 2, 2, 64
    q, k, v = _rnd(rng, B, S, H, hd), _rnd(rng, B, T, KV, hd), \
        _rnd(rng, B, T, KV, hd)
    for kw in ({"causal": False}, {"causal": True}):
        got, pallas, oracle = _flash_all(q, k, v, **kw)
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,C,H,KV,hd", [
    (2, 80, 4, 2, 64), (1, 256, 8, 8, 128), (3, 100, 6, 2, 64)])
def test_decode_plain_matches_pallas_and_ref(B, C, H, KV, hd):
    """Random validity masks (holes anywhere, slot 0 always valid)."""
    rng = np.random.default_rng(C + H)
    q = _rnd(rng, B, 1, H, hd)
    k, v = _rnd(rng, B, C, KV, hd), _rnd(rng, B, C, KV, hd)
    valid = rng.random((B, C)) > 0.3
    valid[:, 0] = True
    scale = hd ** -0.5
    got = tdec.decode_attention(_t(q), _t(k), _t(v), _t(valid),
                                scale).numpy()
    pallas = np.asarray(ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        scale, block_c=32))
    oracle = np.asarray(ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        scale))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


def test_decode_is_flash_last_row():
    """The last row of causal flash attention over T positions is decode
    with the first T slots valid (the two plain versions agree)."""
    rng = np.random.default_rng(2)
    B, T, C, H, KV, hd = 2, 23, 40, 4, 2, 16
    q = _rnd(rng, B, T, H, hd)
    k, v = _rnd(rng, B, C, KV, hd), _rnd(rng, B, C, KV, hd)
    full = tflash.flash_attention(_t(q), _t(k[:, :T]), _t(v[:, :T]),
                                  scale=0.25)
    valid = np.arange(C)[None, :].repeat(B, 0) < T
    dec = tdec.decode_attention(_t(q[:, -1:]), _t(k), _t(v), _t(valid),
                                0.25)
    torch.testing.assert_close(dec, full[:, -1:], atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    q, k, v = _rnd(rng, 2, 8, 4, 16), _rnd(rng, 2, 8, 2, 16), \
        _rnd(rng, 2, 8, 2, 16)
    valid = np.ones((2, 8), bool)
    n0 = (tflash.flash_attention.launches, tdec.decode_attention.launches)
    out = tflash.flash_attention(_t(q), _t(k), _t(v), scale=0.25, window=3)
    want = tflash.flash_attention_plain(_t(q), _t(k), _t(v), scale=0.25,
                                        window=3)
    assert torch.equal(out, want)
    out = tdec.decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(valid), 0.25)
    want = tdec.decode_attention_plain(_t(q[:, :1]), _t(k), _t(v),
                                       _t(valid), 0.25)
    assert torch.equal(out, want)
    assert (tflash.flash_attention.launches,
            tdec.decode_attention.launches) == n0


def test_dense_launch_args_are_validated():
    """What the dense kernels take is checked before any launch: float32
    q/k/v, a bool mask of the cache's (B, C), contiguity, matching
    shapes (here on CPU tensors, which the check itself does not care
    about)."""
    rng = np.random.default_rng(4)
    q, k, v = _t(_rnd(rng, 2, 1, 4, 16)), _t(_rnd(rng, 2, 8, 2, 16)), \
        _t(_rnd(rng, 2, 8, 2, 16))
    valid = torch.ones((2, 8), dtype=torch.bool)
    _build.check_dense_args("t", q, k, v, valid)
    bad = [(q.double(), k, v, valid), (q, k.transpose(1, 2), v, valid),
           (q, k, v, valid.int()), (q, k, v, valid[:, :5]),
           (q, k[:1], v[:1], valid), (q, k, v[:, :, :1], valid),
           (q, k[..., :3], v[..., :3], valid)]
    for args in bad:
        with pytest.raises(ValueError):
            _build.check_dense_args("t", *args)
    with pytest.raises(ValueError):  # 4 query heads over 3 KV heads
        _build.check_dense_args("t", q, k[:, :, :1].repeat(1, 1, 3, 1),
                                v[:, :, :1].repeat(1, 1, 3, 1), valid)


def test_every_kernel_has_a_source_and_its_own_entry_point_types():
    """Each kernel builds from its own csrc source into its own library
    and declares its C entry point's argument types: device pointers,
    then ints, then (the attention kernels) the float scale."""
    attention = {"paged_decode_attention", "paged_decode_attention_splitk",
                 "paged_prefill_attention", "flash_attention",
                 "decode_attention"}
    assert set(_build.KERNELS) == attention | {"rglru_scan", "rwkv6_scan",
                                               "moe_matmul"}
    for name, types in _build.KERNELS.items():
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).name.startswith(f"lib{name}-")
        kinds = [t.__name__ for t in types]
        if name in attention:
            assert kinds.pop() == "c_float"
        n_ptr = kinds.index("c_int")
        assert set(kinds[:n_ptr]) == {"c_void_p"}
        assert set(kinds[n_ptr:]) == {"c_int"}
