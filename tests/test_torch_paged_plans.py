"""The port's paged attention wrappers on the CPU: the head-width limit
they share, and the plain versions at the wide GQA groups the kernels
serve (llama4-maverick's G = 5, arctic-480b's G = 7) against the Pallas
kernels (interpret mode) and the oracles in ``repro.kernels.ref``, on the
same numpy inputs.

The CUDA kernels, and the tile plans their launchers derive from G and
hd, run only on a GPU; ``chip_smoke.py`` holds them against these plain
versions there at G = 2, 5 and 7 and at hd 256.

Tolerance: fp32 attention outputs, atol = rtol = 1e-5 (the two sides sum
in different orders; nothing else differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import prefill_attention as tpre

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_head_dim_limit():
    """The three paged wrappers share one check (decode imports it)."""
    assert tdec._check_head_dim is tpre._check_head_dim
    tdec._check_head_dim("paged_decode_attention", 256)
    with pytest.raises(ValueError, match="head_dim 260"):
        tdec._check_head_dim("paged_decode_attention", 260)


def _inputs(rng, B, T, H, KV, hd, bs, nb):
    n_pool = 1 + B * nb
    k = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pool)).reshape(B, nb).astype(
        np.int32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    return q, k, v, tables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("H,KV", [(10, 2), (14, 2)])
def test_wide_groups_decode_plain_matches_pallas_and_ref(H, KV):
    """G = 5 and 7: one split, and split-K at 1, 2 and 3 splits."""
    rng = np.random.default_rng(H)
    B, hd, bs, nb = 3, 16, 8, 4
    q, k, v, tables = _inputs(rng, B, 1, H, KV, hd, bs, nb)
    lens = np.array([1, 13, nb * bs], np.int32)
    scale = hd ** -0.5
    args = [_j(a) for a in (q, k, v, tables, lens)]
    oracle = np.asarray(ref.paged_decode_attention_ref(*args, scale))
    pallas = np.asarray(ops.paged_decode_attention(*args, scale))
    got = tdec.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                      _t(lens), scale).numpy()
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    for n in (1, 2, 3):
        split = tdec.paged_decode_attention_splitk(
            _t(q), _t(k), _t(v), _t(tables), _t(lens), scale,
            n_splits=n).numpy()
        np.testing.assert_allclose(split, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,KV", [(10, 2), (14, 2)])
def test_wide_groups_prefill_plain_matches_pallas_and_ref(H, KV):
    """G = 5 and 7, chunks starting mid-block."""
    rng = np.random.default_rng(100 + H)
    B, T, hd, bs, nb = 2, 11, 16, 8, 4
    q, k, v, tables = _inputs(rng, B, T, H, KV, hd, bs, nb)
    pos = np.array([4, nb * bs - T], np.int32)
    scale = hd ** -0.5
    args = [_j(a) for a in (q, k, v, tables, pos)]
    oracle = np.asarray(ref.paged_prefill_attention_ref(*args, scale))
    pallas = np.asarray(ops.paged_prefill_attention(*args, scale))
    got = tpre.paged_prefill_attention(_t(q), _t(k), _t(v), _t(tables),
                                       _t(pos), scale).numpy()
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
