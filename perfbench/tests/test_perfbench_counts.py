"""The counts against sums by hand."""
import json
import math
from pathlib import Path

import pytest

import perfbench_fixtures  # noqa: F401  (the checkout on sys.path)
from perfbench.counts import attention, model, peaks

ROOT = Path(__file__).resolve().parents[2]


def conf(name):
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())


def test_yi_34b_l15_sizes():
    c = conf("yi-34b-l15")
    d, f, V = 7168, 20480, 64000
    attn = d * (56 * 128) + 2 * d * (8 * 128) + (56 * 128) * d
    layer = attn + 3 * d * f
    by_hand = 15 * layer + 2 * V * d + (2 * 15 + 1) * d
    p = model.params(c)
    assert p["total"] == by_hand
    assert abs(p["total"] / 1e9 - 9.3) < 0.05
    assert abs(model.weight_bytes(c) / 1e9 - 37.2) < 0.1


def test_chatglm3_6b_sizes():
    c = conf("chatglm3-6b")
    d, f, V = 4096, 13696, 65024
    layer = d * 32 * 128 + 2 * d * 2 * 128 + 32 * 128 * d + 3 * d * f
    assert model.params(c)["total"] == 28 * layer + 2 * V * d + 57 * d
    assert abs(model.weight_bytes(c) / 1e9 - 25.0) < 0.05


SMALL = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10}


def test_gemm_least_seconds_by_hand():
    rows, head = 3, 1
    mats = [(8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)]
    want = 0.0
    for a, b in mats * 2:
        want += max(2 * rows * a * b / peaks.FP32_FLOPS,
                    4 * (a * b + rows * (a + b)) / peaks.HBM_BYTES)
    want += max(2 * head * 8 * 10 / peaks.FP32_FLOPS,
                4 * (80 + head * 18) / peaks.HBM_BYTES)
    assert model.gemm_least_seconds(SMALL, rows, head) == pytest.approx(
        want, rel=1e-12)


def test_causal_pairs_and_model_ops():
    # 3 queries at positions 5, 6, 7 attend 6 + 7 + 8 keys
    assert model.causal_pairs(5, 3) == 21
    layers = sum(a * b for a, b in model.layer_matrices(SMALL)) * 2
    ops = model.model_ops(SMALL, tokens=3, head_rows=1, keys_attended=21)
    assert ops == 2 * layers * 3 + 2 * 80 + 4 * 2 * 4 * 2 * 21


def test_sum_pairs_over_forwards():
    fw = [{"kind": "prefill", "start": 5, "T": 3, "pad": 0, "real": 3},
          {"kind": "decode", "real_contexts": [9, 4]}]
    assert model.sum_pairs(fw) == 21 + 13


@pytest.mark.parametrize("start,T,pad,want", [
    (0, 8, 5, (0, 3)),     # the padding, then the prompt's first 3
    (0, 4, 5, (0, 0)),     # padding only
    (8, 8, 5, (3, 8)),     # past the padding
    (16, 4, 0, (16, 4)),   # an unpadded prompt
])
def test_real_piece_leaves_the_padding_out(start, T, pad, want):
    real = max(0, start + T - max(start, pad))
    f = {"kind": "prefill", "start": start, "T": T, "pad": pad,
         "real": real}
    assert model.real_piece(f) == want
    # queries at prompt positions 0..2 attend 1 + 2 + 3 keys
    if want == (0, 3):
        assert model.sum_pairs([f]) == 6


class _Trace:
    window_s = 2.0


class _Run:
    """What the readers read of a traced run, at SMALL's sizes."""

    def __init__(self, forwards, secs):
        self.cfg, self.block_size, self.trace = SMALL, 16, _Trace()
        self._fw, self._secs = forwards, secs

    def traced_forwards(self):
        return self._fw

    def class_seconds(self, cls):
        return self._secs


#: a decode step of 128 rows with two decoding (padding 3 and 0), and a
#: prompt's last piece of 8 positions, 5 of them padding
FORWARDS = [
    {"kind": "decode", "rows": 128, "contexts_active": [20, 6],
     "real_contexts": [17, 6]},
    {"kind": "prefill", "start": 0, "T": 8, "pad": 5, "real": 3,
     "last": True},
]


def test_readers_count_only_the_work_requests_need():
    from perfbench.harness import cell
    secs = 1e-3
    run = _Run(FORWARDS, secs)
    gemm = cell._reader(ROOT, "gemm_roofline").read(run)
    least = model.gemm_least_seconds(SMALL, 2, 2) \
        + model.gemm_least_seconds(SMALL, 3, 1)
    assert gemm == pytest.approx(100 * least / secs, rel=1e-12)
    mfu = cell._reader(ROOT, "mfu").read(run)
    ops = model.model_ops(SMALL, tokens=2 + 3, head_rows=2 + 1,
                          keys_attended=17 + 6 + 6)
    assert mfu == pytest.approx(100 * ops / (2.0 * peaks.FP32_FLOPS))
    dec = cell._reader(ROOT, "paged_decode_roofline").read(run)
    assert dec == pytest.approx(100 * peaks.least_seconds(
        *attention.paged_decode(SMALL, [17, 6], 16)) / secs)
    pre = cell._reader(ROOT, "paged_prefill_roofline").read(run)
    assert pre == pytest.approx(100 * peaks.least_seconds(
        *attention.paged_prefill(SMALL, 0, 3, 16)) / secs)


def test_paged_decode_by_hand():
    ops, nbytes = attention.paged_decode(SMALL, [17, 1], block_size=16)
    B, H, KV, hd, L = 2, 4, 2, 2, 2
    keys = 18
    want_bytes = 4 * (2 * B * H * hd + 2 * keys * KV * hd + B) + 4 * (2 + 1)
    assert nbytes == L * want_bytes
    assert ops == L * 4 * hd * H * keys


def test_paged_prefill_by_hand():
    ops, nbytes = attention.paged_prefill(SMALL, start=16, T=4,
                                          block_size=16)
    H, KV, hd, L = 4, 2, 2, 2
    keys = 20
    want_bytes = 4 * (2 * 4 * H * hd + 2 * keys * KV * hd + 1) + 4 * 2
    assert nbytes == L * want_bytes
    assert ops == L * 4 * hd * H * (17 + 18 + 19 + 20)


def test_least_seconds_is_the_larger_bound():
    assert peaks.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(peaks.least_seconds(67e12, 6.7e12), 2.0)
