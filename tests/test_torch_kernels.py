"""The port's paged attention kernels, on the CPU: their plain PyTorch
versions held against the JAX Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and the pure-jnp oracles in
``repro.kernels.ref``, on the same numpy inputs.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
them against these plain versions there. Here the wrappers must route
CPU tensors to the plain version without counting a launch.

Tolerance: fp32 attention outputs, atol = rtol = 1e-5 (the two sides
sum in different orders; nothing else differs).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import prefill_attention as tpre

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


def _inputs(rng, B, T, H, KV, hd, bs, nb, n_extra=2):
    """Pools, shuffled distinct tables (never the null block) and q."""
    n_pool = 1 + B * nb + n_extra
    k = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pool, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pool))[:B * nb].reshape(
        B, nb).astype(np.int32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    return q, k, v, tables


def _null_pad(tables, live):
    out = np.array(tables)
    for b in range(out.shape[0]):
        out[b, live[b]:] = 0
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("seed,B,bs,null_pad", [
    (0, 1, 4, False), (1, 3, 8, True), (2, 2, 16, False), (3, 4, 8, True),
    (4, 3, 16, True)])
def test_decode_plain_matches_pallas_and_ref(seed, B, bs, null_pad):
    """Ragged seq_lens (1 and full capacity included), block sizes and
    null-padded tables: plain == Pallas (interpret) == ref."""
    rng = np.random.default_rng(seed)
    H, KV, hd, nb = 4, 2, 16, int(rng.integers(1, 5))
    q, k, v, tables = _inputs(rng, B, 1, H, KV, hd, bs, nb)
    lens = rng.integers(1, nb * bs + 1, B).astype(np.int32)
    lens[0] = 1
    lens[-1] = nb * bs if B > 1 else lens[-1]
    if null_pad:
        tables = _null_pad(tables, [-(-int(n) // bs) for n in lens])
    scale = hd ** -0.5
    got = tdec.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                      _t(lens), scale).numpy()
    pallas = np.asarray(ops.paged_decode_attention(
        _j(q), _j(k), _j(v), _j(tables), _j(lens), scale))
    oracle = np.asarray(ref.paged_decode_attention_ref(
        _j(q), _j(k), _j(v), _j(tables), _j(lens), scale))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed,B,T,bs,null_pad", [
    (0, 1, 1, 4, False), (1, 2, 5, 8, True), (2, 1, 16, 8, False),
    (3, 3, 13, 16, True), (4, 2, 8, 4, True)])
def test_prefill_plain_matches_pallas_and_ref(seed, B, T, bs, null_pad):
    """Chunks at ragged starts (mid-block included) over shuffled tables:
    plain == Pallas (interpret) == ref."""
    rng = np.random.default_rng(100 + seed)
    H, KV, hd = 4, 2, 16
    nb = -(-T // bs) + int(rng.integers(0, 3))
    q, k, v, tables = _inputs(rng, B, T, H, KV, hd, bs, nb)
    pos = rng.integers(0, nb * bs - T + 1, B).astype(np.int32)
    if B > 1:
        pos[0] = min(bs // 2, nb * bs - T)  # a chunk starting mid-block
    if null_pad:
        tables = _null_pad(tables, [-(-int(p + T) // bs) for p in pos])
    scale = hd ** -0.5
    got = tpre.paged_prefill_attention(_t(q), _t(k), _t(v), _t(tables),
                                       _t(pos), scale).numpy()
    pallas = np.asarray(ops.paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(tables), _j(pos), scale))
    oracle = np.asarray(ref.paged_prefill_attention_ref(
        _j(q), _j(k), _j(v), _j(tables), _j(pos), scale))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_plain_never_reads_dead_columns_or_unattended_slots(kernel):
    """Poison proof: dead table columns hold garbage (out-of-range and
    negative ids, the index of a NaN block) and every slot no query row
    attends is NaN, the null block included. The plain version must stay
    finite and equal the oracle on a clean table."""
    rng = np.random.default_rng(7)
    B, H, KV, hd, bs, nb = 3, 4, 2, 16, 8, 4
    T = 1 if kernel == "decode" else 5
    q, k, v, tables = _inputs(rng, B, T, H, KV, hd, bs, nb)
    ends = np.array([T, 2 * bs + 3, nb * bs], np.int32)  # slots attended
    live = [-(-int(n) // bs) for n in ends]
    clean = _null_pad(tables, live)
    bad = np.array(clean)
    junk = np.array([2 ** 30, -3, k.shape[0], 0], np.int32)
    kp, vp = k.copy(), v.copy()
    for b in range(B):
        bad[b, live[b]:] = junk[np.arange(nb - live[b]) % 4]
        last = clean[b, live[b] - 1]
        kp[last, (ends[b] - 1) % bs + 1:] = np.nan
        vp[last, (ends[b] - 1) % bs + 1:] = np.nan
    used = set(clean[clean > 0].ravel().tolist())
    for blk in range(k.shape[0]):
        if blk not in used:
            kp[blk] = np.nan
            vp[blk] = np.nan
    scale = hd ** -0.5
    if kernel == "decode":
        got = tdec.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bad),
                                          _t(ends), scale).numpy()
        want = ref.paged_decode_attention_ref(_j(q), _j(k), _j(v),
                                              _j(clean), _j(ends), scale)
    else:
        pos = ends - T
        got = tpre.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(bad),
                                           _t(pos), scale).numpy()
        want = ref.paged_prefill_attention_ref(_j(q), _j(k), _j(v),
                                               _j(clean), _j(pos), scale)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_decode_is_one_row_prefill():
    """A one-row chunk at position p attends slots <= p: exactly decode
    with seq_len = p + 1 (the two plain versions' masks agree)."""
    rng = np.random.default_rng(5)
    q, k, v, tables = _inputs(rng, 3, 1, 4, 2, 16, 8, 3)
    pos = np.array([0, 9, 23], np.int32)
    a = tpre.paged_prefill_attention(_t(q), _t(k), _t(v), _t(tables),
                                     _t(pos), 0.25)
    b = tdec.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                    _t(pos + 1), 0.25)
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    q, k, v, tables = _inputs(rng, 2, 4, 4, 2, 16, 8, 2)
    pos = np.array([0, 5], np.int32)
    n0 = (tdec.paged_decode_attention.launches,
          tpre.paged_prefill_attention.launches)
    out = tpre.paged_prefill_attention(_t(q), _t(k), _t(v), _t(tables),
                                       _t(pos), 0.25)
    want = tpre.paged_prefill_attention_plain(_t(q), _t(k), _t(v),
                                              _t(tables), _t(pos), 0.25)
    assert torch.equal(out, want)
    tdec.paged_decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(tables),
                                _t(pos + 1), 0.25)
    assert (tdec.paged_decode_attention.launches,
            tpre.paged_prefill_attention.launches) == n0


def test_launch_args_are_validated():
    """What the CUDA kernels take is checked before any launch: float32,
    int32 tables, contiguity, shapes (here on CPU tensors, which the
    check itself does not care about)."""
    rng = np.random.default_rng(4)
    q, k, v, tables = _inputs(rng, 2, 1, 4, 2, 16, 8, 2)
    lens = _t(np.array([3, 9], np.int32))
    args = [_t(q), _t(k), _t(v), _t(tables), lens]
    _build.check_launch_args("t", *args)
    bad = {0: _t(q).double(), 3: _t(tables).long(),
           1: _t(k).transpose(0, 1), 4: lens[:1]}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            _build.check_launch_args("t", *[t if j == i else a
                                            for j, a in enumerate(args)])
    with pytest.raises(ValueError):  # 4 query heads over 3 KV heads
        _build.check_launch_args("t", _t(q), _t(k[:, :, :1].repeat(3, 2)),
                                 _t(v[:, :, :1].repeat(3, 2)),
                                 _t(tables), lens)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building a kernel is an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_tracks_the_sources():
    """Libraries are keyed by a hash of every csrc source and the flags,
    under the gitignored build directory."""
    paths = {n: _build.library_path(n) for n in _build.KERNELS}
    for n, p in paths.items():
        assert p.parent == _build.BUILD_DIR and n in p.name
        assert p.name.endswith(f"-{_build._digest()}.so")
    assert (_build.CSRC / "paged_decode_attention.cu").is_file()
    assert (_build.CSRC / "paged_prefill_attention.cu").is_file()
    ignore = open(os.path.join(os.path.dirname(__file__), "..",
                               ".gitignore")).read().split()
    assert "build/" in ignore
    assert _build.BUILD_DIR.parent.name == "build"
