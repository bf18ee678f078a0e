"""The port's flash attention and dense decode at recurrentgemma-2b's MQA
head shape (10 query heads over one KV head of 256), and the split
arithmetic the card's dense decode runs, on the CPU.

On the card both kernels run the bodies the paged kernels run; dense
decode cuts its cache into :func:`dense_split_plan`'s splits, each
writing an unnormalised ``(acc, m, l)``, merged by the split-K combine.
Here the plain versions are held against the JAX Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and the pure-jnp
oracles in ``repro.kernels.ref`` on the same numpy inputs, and the split
arithmetic in plain PyTorch (``splitk_plain``: masked per-split partials,
then ``splitk_combine_plain``) against the same two, over linear, round,
wrapping ring and sparse masks, with splits that hold no valid slot.

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds them against
the plain versions there, at the same masks, on NaN-poisoned inputs.

Tolerance: fp32 attention outputs, atol = rtol = 1e-5 (the splits and the
two sides sum in different orders; nothing else differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash

ATOL = RTOL = 1e-5
#: recurrentgemma-2b's local attention heads
MQA = {"H": 10, "KV": 1, "hd": 256}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("S,T,kw", [
    (96, 96, {"window": 64}),
    (96, 96, {}),
    (40, 100, {"causal": False}),
    (40, 100, {"causal": False, "window": 16}),
    (100, 40, {}),
    (100, 40, {"window": 64})])
def test_flash_plain_at_mqa_matches_pallas_and_ref(S, T, kw):
    """Window 64 (the reduced config's), causal, non-causal with T != S
    (T off the block size), also windowed, and causal with more query
    rows than K/V rows (rows past T attend every K/V row)."""
    rng = np.random.default_rng(S + T + len(kw))
    H, KV, hd = MQA["H"], MQA["KV"], MQA["hd"]
    q, k, v = _rnd(rng, 1, S, H, hd), _rnd(rng, 1, T, KV, hd), \
        _rnd(rng, 1, T, KV, hd)
    scale = hd ** -0.5
    got = tflash.flash_attention(_t(q), _t(k), _t(v), scale=scale,
                                 **kw).numpy()
    pallas = np.asarray(ops.flash_attention(_j(q), _j(k), _j(v), scale=scale,
                                            block_q=32, block_k=32, **kw))
    oracle = np.asarray(ref.flash_attention_ref(_j(q), _j(k), _j(v),
                                                scale=scale, **kw))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


def _valid(mode, B, C, rng, window=None):
    """The masks of chip_smoke.decode_case, every row with a valid slot:
    ragged linear frontiers, one round frontier, the reference's ring
    mask (positions wrapping past C), or a few scattered slots; past five
    rows the frontiers and positions repeat."""
    slots = np.arange(C)[None, :]
    if mode == "linear":
        lens = np.resize([1, 17, C // 2, C - 1, C], B)
        return slots < lens[:, None]
    if mode == "round":
        return np.broadcast_to(slots < C - 16, (B, C)).copy()
    if mode == "ring":
        pos = np.resize([5, C - 1, C, C + 60, 3 * C + 7], B)
        k_pos = pos[:, None] - ((pos[:, None] - slots) % C)
        return (k_pos >= 0) & (k_pos > pos[:, None] - (window or C))
    valid = np.zeros((B, C), bool)
    for b in range(B):
        valid[b, rng.choice(C, b + 1, replace=False)] = True
    return valid


def _decode_case(mode, B, C, H, KV, hd, seed, window=None):
    rng = np.random.default_rng(seed)
    q = _rnd(rng, B, 1, H, hd)
    k, v = _rnd(rng, B, C, KV, hd), _rnd(rng, B, C, KV, hd)
    return q, k, v, _valid(mode, B, C, rng, window), hd ** -0.5


def _jax_sides(q, k, v, valid, scale):
    args = [_j(a) for a in (q, k, v, valid)]
    pallas = np.asarray(ops.decode_attention(*args, scale, block_c=32))
    oracle = np.asarray(ref.decode_attention_ref(*args, scale))
    return pallas, oracle


@pytest.mark.parametrize("C,window", [(64, 64), (96, 48)])
def test_decode_plain_at_mqa_ring_matches_pallas_and_ref(C, window):
    """A wrapping ring mask at the MQA head shape."""
    q, k, v, valid, scale = _decode_case("ring", 5, C, **MQA, seed=C,
                                         window=window)
    got = tdec.decode_attention(_t(q), _t(k), _t(v), _t(valid),
                                scale).numpy()
    pallas, oracle = _jax_sides(q, k, v, valid, scale)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["linear", "round", "ring", "sparse"])
@pytest.mark.parametrize("heads,C,n_sm", [
    (MQA, 160, 132),                       # 10 columns: 5 splits of 32
    (MQA, 100, 16),                        # 7 columns: 3 splits of 48
    ({"H": 4, "KV": 2, "hd": 16}, 80, 132),
    ({"H": 14, "KV": 2, "hd": 16}, 200, 40)])
def test_dense_split_arithmetic_matches_pallas_and_ref(mode, heads, C,
                                                       n_sm):
    """The card's dense decode: :func:`dense_split_plan`'s splits of C,
    each a masked softmax partial (a split with no valid slot gives m =
    NEG, l = 0, acc = 0 and weighs 0), merged by the combine; invalid
    slots hold NaN on the split side and never reach the output."""
    B = 5
    q, k, v, valid, scale = _decode_case(mode, B, C, **heads,
                                         seed=C + heads["H"])
    S, span = tdec.dense_split_plan(B, heads["KV"], C, n_sm)
    assert S > 1 and S * span >= C > (S - 1) * span
    if mode in ("ring", "sparse"):  # some split of some row is empty
        per_split = np.pad(valid, ((0, 0), (0, S * span - C))).reshape(
            B, S, span).any(-1)
        assert not per_split.all()
    poisoned_k, poisoned_v = k.copy(), v.copy()
    poisoned_k[~valid], poisoned_v[~valid] = np.nan, np.nan
    got = tdec.splitk_plain(_t(q), _t(poisoned_k), _t(poisoned_v),
                            _t(valid), scale, S, span).numpy()
    assert np.isfinite(got).all()
    pallas, oracle = _jax_sides(q, k, v, valid, scale)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    whole = tdec.decode_attention_plain(
        _t(q), _t(np.where(valid[..., None, None], k, 0)),
        _t(np.where(valid[..., None, None], v, 0)), _t(valid), scale)
    np.testing.assert_allclose(got, whole.numpy(), atol=ATOL, rtol=RTOL)


def test_a_row_with_no_valid_slot_comes_out_as_zeros():
    """Every split of the row is empty: the combine's clamped denominator
    gives zeros, as the kernel writes (the reference would average every
    slot's value)."""
    q, k, v, valid, scale = _decode_case("sparse", 3, 64, **MQA, seed=1)
    valid[1] = False
    k[~valid], v[~valid] = np.nan, np.nan
    got = tdec.splitk_plain(_t(q), _t(k), _t(v), _t(valid), scale, 4, 16)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert torch.isfinite(got).all() and got[0].abs().sum() > 0


@pytest.mark.parametrize("B,KV,C,want", [
    (8, 1, 2048, (16, 128)),   # recurrentgemma-2b's ring, wrapping or
                               # filled to 528 by a round: 16 x 128 slots
    (8, 1, 640, (14, 48)),     # its dense engine's 640-slot rows
    (8, 8, 544, (2, 272)),     # qwen3-0.6b's round cache
    (8, 8, 640, (2, 320)),     # qwen3-0.6b's dense engine
    (32, 8, 640, (1, 640)),    # B * KV = 256 > 132 SMs: one split
    (1, 1, 16, (1, 16)), (1, 1, 20, (1, 32))])  # one or two columns
def test_dense_split_plan(B, KV, C, want):
    """decode_splits and split_plan over ceil(C / 16) columns of 16
    slots, on the H100's 132 SMs: the MQA rows (B * KV = 8) take 16
    splits, capped by the columns; GQA at B * KV = 64 takes 2."""
    assert tdec.dense_split_plan(B, KV, C, 132) == want


@pytest.mark.parametrize("B,KV,C,n_splits,want", [
    (8, 1, 2048, 1, (1, 2048)), (8, 8, 640, 4, (4, 160)),
    (32, 8, 640, 4, (4, 160)), (1, 1, 20, 8, (2, 16))])
def test_dense_split_plan_with_a_given_count(B, KV, C, n_splits, want):
    """A given split count replaces the rule's, clamped and trimmed by
    split_plan over the 16-slot columns."""
    assert tdec.dense_split_plan(B, KV, C, 132, n_splits) == want


@pytest.mark.parametrize("B,KV,C,mode", [
    (32, 8, 640, "linear"),   # B * KV = 256: the rule's one split
    (8, 8, 16, "linear"),     # one 16-slot column: one split
    (8, 1, 640, "ring")])     # the rule's 14 splits
def test_one_split_and_many_agree(B, KV, C, mode):
    """The card's dense decode at one split (normalised in the body) and
    at four (partials, then the combine) is one function: both sides of
    the split arithmetic agree with the oracle and with each other."""
    heads = {"H": 2 * KV, "KV": KV, "hd": 16}
    q, k, v, valid, scale = _decode_case(mode, B, C, **heads, seed=B + C)
    oracle = np.asarray(ref.decode_attention_ref(
        *[_j(a) for a in (q, k, v, valid)], scale))
    outs = []
    for n in (1, 4, None):
        S, span = tdec.dense_split_plan(B, KV, C, 132, n)
        outs.append(tdec.splitk_plain(_t(q), _t(k), _t(v), _t(valid),
                                      scale, S, span).numpy())
        np.testing.assert_allclose(outs[-1], oracle, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL, rtol=RTOL)


def test_paged_split_plain_is_splitk_plain_on_the_gathered_view():
    """The paged split plain version is the dense one over the view its
    table gathers: one split arithmetic for both kernels."""
    rng = np.random.default_rng(7)
    B, bs, nb, H, KV, hd = 3, 8, 5, 4, 2, 16
    n_pool = 1 + B * nb
    kp, vp = _rnd(rng, n_pool, bs, KV, hd), _rnd(rng, n_pool, bs, KV, hd)
    tables = rng.permutation(np.arange(1, n_pool)).reshape(B, nb).astype(
        np.int32)
    lens = np.array([1, 19, nb * bs], np.int32)
    q = _rnd(rng, B, 1, H, hd)
    got = tdec.paged_decode_attention_splitk_plain(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lens), 0.25, n_splits=2)
    k, v = kp[tables].reshape(B, nb * bs, KV, hd), \
        vp[tables].reshape(B, nb * bs, KV, hd)
    valid = np.arange(nb * bs)[None, :] < lens[:, None]
    S, bps = tdec.split_plan(nb, 2)
    want = tdec.splitk_plain(_t(q), _t(k), _t(v), _t(valid), 0.25, S,
                             bps * bs)
    assert torch.equal(got, want)
