"""The port's split-K paged decode, on the CPU: its plain PyTorch version
(the per-split ``(acc, m, l)`` partials and the log-sum-exp combine)
held against the JAX Pallas kernel ``paged_decode_attention_splitk``
(interpret mode, as tests/test_paged_prefill_kernel.py runs it), against
the plain paged decode oracle in ``repro.kernels.ref`` and against the
port's unsplit decode, on the same numpy inputs; and the dispatch rule
``decode_splits`` that picks split-K on the card.

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against
this plain version there.

Tolerance: fp32 attention outputs, atol = rtol = 1e-5 (the splits and
the two sides sum in different orders; nothing else differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(rng, B, bs, nb, H=4, KV=2, hd=16, n_extra=2):
    """Pools, shuffled distinct tables (never the null block), q and
    ragged lens that include 1 and the full table."""
    n_pool = 1 + B * nb + n_extra
    k = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pool))[:B * nb].reshape(
        B, nb).astype(np.int32)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    lens = rng.integers(1, nb * bs + 1, B).astype(np.int32)
    lens[0] = 1
    if B > 1:
        lens[-1] = nb * bs
    return q, k, v, tables, lens, hd ** -0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(q, k, v, tables, lens, scale, n_splits):
    return tdec.paged_decode_attention_splitk_plain(
        _t(q), _t(k), _t(v), _t(tables), _t(lens), scale,
        n_splits).numpy()


@pytest.mark.parametrize("seed,bs,n_splits,B,nb", [
    (0, 4, 1, 1, 5), (1, 8, 2, 3, 6), (2, 16, 3, 2, 4), (3, 4, 4, 3, 7),
    (4, 8, 8, 2, 5), (5, 16, 16, 1, 3), (6, 4, 3, 2, 7)])
def test_splitk_plain_matches_pallas_and_ref(seed, bs, n_splits, B, nb):
    """Ragged lens (1 and the full table), nb % n_splits != 0, more
    splits than blocks, splits left empty by short sequences: plain ==
    Pallas (interpret) == ref."""
    rng = np.random.default_rng(seed)
    q, k, v, tables, lens, scale = _case(rng, B, bs, nb)
    got = _plain(q, k, v, tables, lens, scale, n_splits)
    args = [jnp.asarray(a) for a in (q, k, v, tables, lens)]
    want = ref.paged_decode_attention_splitk_ref(*args, scale)
    pallas = ops.paged_decode_attention_splitk(*args, scale,
                                               n_splits=n_splits)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL,
                               rtol=RTOL)


def test_splitk_plain_matches_the_serial_decode():
    """Partitioning is an implementation detail: split-K and the unsplit
    sweep agree for every split count, including the clamped last split
    (nb = 6 in 4 splits of 2 leaves 3)."""
    rng = np.random.default_rng(6)
    q, k, v, tables, _, scale = _case(rng, 2, 8, 6)
    lens = np.array([5, 48], np.int32)
    serial = tdec.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                         _t(lens), scale).numpy()
    for ns in (1, 2, 3, 4, 6, 16):
        np.testing.assert_allclose(
            _plain(q, k, v, tables, lens, scale, ns), serial, atol=ATOL,
            rtol=RTOL)


def test_splitk_single_block_and_full_capacity():
    """One table column, more splits than blocks; a ragged and a full
    sequence."""
    rng = np.random.default_rng(8)
    q, k, v, _, _, scale = _case(rng, 2, 8, 2)
    tables = np.array([[2], [4]], np.int32)
    lens = np.array([3, 8], np.int32)
    got = _plain(q, k, v, tables, lens, scale, 4)
    want = ref.paged_decode_attention_ref(
        *[jnp.asarray(a) for a in (q, k, v, tables, lens)], scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_splits", [2, 4])
def test_splitk_never_reads_padded_columns(n_splits):
    """Dead table columns hold an id of a NaN block, ids past the pool
    and negative ids, and every slot past each frontier is NaN: none of
    it reaches the output (the Pallas kernel, run on the same poisoned
    inputs, agrees)."""
    rng = np.random.default_rng(11)
    B, bs, nb = 3, 8, 4
    q, k, v, tables, _, scale = _case(rng, B, bs, nb)
    lens = np.array([1, 2 * bs, 3 * bs - 3], np.int32)
    bad = k.shape[0] - 1
    k[bad] = np.nan
    v[bad] = np.nan
    clean = tables.copy()
    for b, n in enumerate(lens):
        live = -(-int(n) // bs)
        for j in range(live, nb):
            tables[b, j] = (bad, 10 ** 6, -3)[j % 3]
            clean[b, j] = 1
        for t in range(n, live * bs):  # the live blocks' unattended tail
            k[tables[b, t // bs], t % bs] = np.nan
            v[tables[b, t // bs], t % bs] = np.nan
    got = _plain(q, k, v, tables, lens, scale, n_splits)
    assert np.isfinite(got).all()
    want = ref.paged_decode_attention_ref(
        *[jnp.asarray(a) for a in (q, np.nan_to_num(k), np.nan_to_num(v),
                                   clean, lens)], scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_combine_weighs_an_empty_split_zero():
    """An empty split (m = NEG, l = 0, acc = 0) changes nothing; the
    combine rescales the others to the global max and clamps l."""
    rng = np.random.default_rng(2)
    acc = torch.from_numpy(rng.standard_normal((1, 2, 2, 4)).astype(
        np.float32))
    m = torch.tensor([[[0.5, -1.0], [2.0, 1.0]]])
    l = torch.tensor([[[1.5, 2.0], [0.7, 0.3]]])
    two = tdec.splitk_combine_plain(acc, m, l)
    acc3 = torch.cat([acc, torch.zeros(1, 2, 1, 4)], 2)
    m3 = torch.cat([m, torch.full((1, 2, 1), tdec.NEG)], 2)
    l3 = torch.cat([l, torch.zeros(1, 2, 1)], 2)
    assert torch.equal(tdec.splitk_combine_plain(acc3, m3, l3), two)
    w = torch.exp(m - m.max(-1, keepdim=True).values)
    want = (acc * w[..., None]).sum(2) / (l * w).sum(-1)[..., None]
    torch.testing.assert_close(two[:, 0], want)
    zero = tdec.splitk_combine_plain(torch.zeros(1, 1, 2, 4),
                                     torch.full((1, 1, 2), tdec.NEG),
                                     torch.zeros(1, 1, 2))
    assert torch.equal(zero, torch.zeros(1, 1, 1, 4))


@pytest.mark.parametrize("nb,n_splits,want", [
    (7, 4, (4, 2)), (36, 16, (12, 3)), (36, 4, (4, 9)), (36, 8, (8, 5)),
    (256, 16, (16, 16)), (6, 4, (3, 2)), (3, 8, (3, 1)), (5, 0, (1, 5))])
def test_split_plan_is_the_references(nb, n_splits, want):
    """n_splits clamped to [1, nb], bps = ceil(nb / n_splits), then
    ceil(nb / bps) splits (decode_attention.py:315-318)."""
    assert tdec.split_plan(nb, n_splits) == want


@pytest.mark.parametrize("B,KV,nb,want", [
    (4, 8, 36, 4),      # the pool at b <= 4: split in 4
    (2, 8, 36, 8), (1, 8, 36, 16), (1, 8, 256, 16),
    (8, 8, 40, 2),      # the 8-slot drains: B * KV = 64 <= 132, 2 splits
    (5, 8, 36, 3),      # 40: 132 // 40
    (4, 2, 12, 6),      # reduced width: capped by nb // 2
    (2, 2, 4, 2), (1, 8, 2, 1),  # a two-column table: nb // 2 = 1
    (33, 1, 100, 4), (34, 1, 100, 3), (0, 8, 36, 1),
    (16, 8, 40, 2),     # 128: at least 2 splits up to n_sm
    (32, 8, 40, 1),     # 256 > 132: one split (32 slots)
    (132, 1, 100, 2), (133, 1, 100, 1)])
def test_decode_splits_rule(B, KV, nb, want):
    """split only when B * KV <= n_sm (132), into min(16, max(2, n_sm //
    (B * KV)), nb // 2) segments; 1 = the one-split kernel (the measured
    crossover lies between B * KV = 128 and 256)."""
    assert tdec.decode_splits(B, KV, nb, 132) == want


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    q, k, v, tables, lens, scale = _case(rng, 2, 8, 3)
    n0 = tdec.paged_decode_attention_splitk.launches
    out = tdec.paged_decode_attention_splitk(_t(q), _t(k), _t(v),
                                             _t(tables), _t(lens), scale,
                                             n_splits=2)
    assert torch.equal(out, torch.from_numpy(
        _plain(q, k, v, tables, lens, scale, 2)))
    assert tdec.paged_decode_attention_splitk.launches == n0
    assert "paged_decode_attention_splitk" in _build.KERNELS
    assert (_build.CSRC / "paged_decode_attention_splitk.cu").is_file()
    with pytest.raises(ValueError, match="no kernel"):
        tdec.paged_decode_attention_splitk(
            _t(q).to("meta"), _t(k), _t(v), _t(tables), _t(lens), scale)
