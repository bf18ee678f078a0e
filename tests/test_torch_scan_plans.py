"""The launch plans of the port's recurrent scan kernels, on the CPU.

``rwkv6_plan`` splits each head's (hd, hd) state over blocks of JC value
columns, each thread holding ROWS = 4 key rows of 4 columns, R threads
per 4 columns;
``rglru_plan`` splits (B, S, W) over 32-channel blocks and, where the
channels alone cannot fill the card, over time chunks that the kernel
runs in two passes (chunk summaries, then each chunk from its folded
start state). Both are pure functions of shapes: here every element is
checked to be covered exactly once, and the arithmetic each plan implies
is emulated in numpy and held against the pure-jnp oracles in
``repro.kernels.ref``. The CUDA kernels themselves run only on a GPU,
where ``chip_smoke.py`` holds them against their plain versions.

Tolerances: RG-LRU atol 1e-5 / rtol 1e-4 (tests/test_kernels.py's: one
multiply-add per step; only the chunks' start states round differently),
RWKV-6 atol 1e-4 / rtol 1e-3 (an hd-long sum per output, in another
order).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref
from repro_torch.kernels.rglru_scan import rglru_plan
from repro_torch.kernels.rwkv6_scan import (COLS, MAX_SMEM, MAX_THREADS,
                                            rwkv6_plan, rwkv6_smem)

#: the H100's SMs
N_SM = 132
RGLRU_TOL = dict(atol=1e-5, rtol=1e-4)
RWKV_TOL = dict(atol=1e-4, rtol=1e-3)


def _rwkv_tiles(B, H, hd, plan):
    """Yield (b, h, columns, rows) for every (block, thread) of the plan:
    grid (ceil(hd / JC), H, B), thread tid = g * JC / 4 + cq of
    JC / 4 * R owning columns j0 + 4 cq .. + 3 and rows g * ROWS ..
    + ROWS - 1 (those below hd)."""
    jc, R, rows = plan
    cols = COLS
    for b, h, jg in itertools.product(range(B), range(H),
                                      range(-(-hd // jc))):
        for tid in range(jc // cols * R):
            g, cq = divmod(tid, jc // cols)
            j0 = jg * jc + cols * cq
            yield b, h, [j for j in range(j0, j0 + cols) if j < hd], \
                [i for i in range(g * rows, (g + 1) * rows) if i < hd]


@pytest.mark.parametrize("hd", [1, 48, 64, 128])
@pytest.mark.parametrize("B", [1, 8])
def test_rwkv6_plan_covers_every_state_element_once(B, hd):
    H = 3
    plan = rwkv6_plan(B, H, hd, N_SM)
    jc, R, rows = plan
    assert jc in (8, 16, 32, 64) and jc // COLS * R <= MAX_THREADS
    assert R * rows >= hd > R * rows - rows  # no thread holds only pad
    assert rwkv6_smem(jc, R) <= MAX_SMEM
    seen = np.zeros((B, H, hd, hd), np.int64)
    for b, h, js, rs in _rwkv_tiles(B, H, hd, plan):
        seen[b, h][np.ix_(rs, js)] += 1
    assert (seen == 1).all()


def test_rwkv6_plan_for_rwkv6_3b():
    """One 512-token chunk of rwkv6-3b (B = 1, 40 heads of 64) takes the
    narrowest column groups whose blocks fit one wave of one block per
    SM; eight sequences, more blocks than SMs at any width, take the
    widest groups (fewest re-reads of r, k and w)."""
    jc, R, rows = rwkv6_plan(1, 40, 64, N_SM)
    assert (jc, R, rows) == (32, 16, 4)
    assert 40 * -(-64 // jc) <= N_SM < 40 * -(-64 // (jc // 2))
    assert rwkv6_plan(8, 40, 64, N_SM) == (64, 16, 4)
    # hd 128: 64 columns would take 512 threads, 32 too much shared memory
    assert rwkv6_plan(8, 40, 128, N_SM)[0] == 16


def _rglru_tiles(B, S, W, plan):
    """Yield (b, steps, channels) of every block of the plan: grid
    (ceil(W / CB), C, B), chunk c holding steps [c L, min(S, (c+1) L))."""
    cb, C, L = plan
    for b, c, wg in itertools.product(range(B), range(C),
                                      range(-(-W // cb))):
        yield b, range(c * L, min(S, (c + 1) * L)), \
            range(wg * cb, min(W, (wg + 1) * cb))


@pytest.mark.parametrize("S", [33, 1000])
@pytest.mark.parametrize("B", [1, 2])
def test_rglru_plan_covers_every_step_once_with_a_ragged_last_chunk(B, S):
    W = 100
    plan = rglru_plan(B, S, W, N_SM)
    cb, C, L = plan
    assert cb == 32 and 1 < C <= 16
    assert S % L != 0  # the last chunk is short
    seen = np.zeros((B, S, W), np.int64)
    for b, steps, chans in _rglru_tiles(B, S, W, plan):
        assert len(steps) > 0  # no empty chunk
        seen[b, steps.start:steps.stop, chans.start:chans.stop] += 1
    assert (seen == 1).all()


def test_rglru_plan_chunks_only_where_the_channels_cannot_fill_the_card():
    """recurrentgemma-2b (W = 2560): eight sequences take one pass, one
    sequence splits its 512 steps; no plan exceeds 16 chunks or makes an
    empty one."""
    assert rglru_plan(8, 512, 2560, N_SM) == (32, 1, 512)
    cb, C, L = rglru_plan(1, 512, 2560, N_SM)
    assert C > 1 and (C - 1) * L < 512 <= C * L
    for B, S, W in itertools.product((1, 2, 8, 64), (0, 1, 15, 16, 33, 512,
                                                     1000, 4096),
                                     (1, 100, 2560)):
        cb, C, L = rglru_plan(B, S, W, N_SM)
        assert 1 <= C <= 16 and L >= 1
        assert C * L >= S and (C == 1 or (C - 1) * L < S)
        if B * W >= 128 * N_SM:
            assert C == 1


def _two_pass(a, x, h0, plan):
    """The kernel's arithmetic in numpy float32: pass 1 composes every
    chunk but the last into (A = prod a, X = h from 0); pass 2 folds the
    summaries before its chunk into the start state, then runs the chunk
    sequentially. Every multiply and add rounded on its own."""
    _, C, L = plan
    B, S, W = a.shape
    A = np.ones((B, C, W), np.float32)
    X = np.zeros((B, C, W), np.float32)
    for c in range(C - 1):
        for t in range(c * L, min(S, (c + 1) * L)):
            X[:, c] = a[:, t] * X[:, c] + x[:, t]
            A[:, c] = A[:, c] * a[:, t]
    hs = np.empty_like(a)
    h_final = None
    for c in range(C):
        h = h0.copy()
        for cc in range(c):
            h = A[:, cc] * h + X[:, cc]
        for t in range(c * L, min(S, (c + 1) * L)):
            h = a[:, t] * h + x[:, t]
            hs[:, t] = h
        h_final = h
    return hs, h_final


@pytest.mark.parametrize("lo,hi", [(0.4, 0.9), (0.9, 0.999)])
def test_rglru_two_pass_composition_matches_the_reference(lo, hi):
    """The two-pass form, at the plan's chunks, against the sequential
    jnp oracle over 2048 steps, at tests/test_kernels.py's decays and at
    recurrentgemma-2b's (0.9, 0.999) (models/rglru.py)."""
    B, S, W = 2, 2048, 64
    plan = rglru_plan(B, S, W, N_SM)
    assert plan[1] == 16
    rng = np.random.default_rng(11)
    a = (rng.random((B, S, W)) * (hi - lo) + lo).astype(np.float32)
    x = (rng.standard_normal((B, S, W)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((B, W)) * 0.1).astype(np.float32)
    hs, h_final = _two_pass(a, x, h0, plan)
    want_hs, want_h = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                         jnp.asarray(h0))
    np.testing.assert_allclose(hs, np.asarray(want_hs), **RGLRU_TOL)
    np.testing.assert_allclose(h_final, np.asarray(want_h), **RGLRU_TOL)


@pytest.mark.parametrize("hd", [48, 64])
def test_rwkv6_state_split_matches_the_reference(hd):
    """The kernel's decomposition in numpy float32: each thread's ROWS
    rows of its columns update their state elements and sum a partial of
    out; the R partials are summed in order. At rwkv6-3b's range of w
    (exp(-exp(z)), z in (-6, 1): 0.066 to 0.9975), against the jnp
    oracle."""
    B, S, H = 1, 64, 2
    _, R, rows = rwkv6_plan(B, H, hd, N_SM)
    rng = np.random.default_rng(hd)
    seq = (B, S, H, hd)
    r = rng.standard_normal(seq).astype(np.float32)
    k = (rng.standard_normal(seq) * 0.3).astype(np.float32)
    v = (rng.standard_normal(seq) * 0.3).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(-6, 1, seq))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    st = s0.copy()
    out = np.zeros(seq, np.float32)
    groups = [slice(g * rows, min(hd, (g + 1) * rows)) for g in range(R)]
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,i,j)
        terms = r[:, t, :, :, None] * (st + u[None, :, :, None] * kv)
        for g in groups:  # each thread's partial, then the R in order
            out[:, t] += terms[:, :, g].sum(2)
        st = w[:, t, :, :, None] * st + kv
    want_out, want_state = ref.rwkv6_scan_ref(*(jnp.asarray(z) for z in
                                                (r, k, v, w, u, s0)))
    np.testing.assert_allclose(out, np.asarray(want_out), **RWKV_TOL)
    np.testing.assert_allclose(st, np.asarray(want_state), **RWKV_TOL)
