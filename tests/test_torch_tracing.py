"""The engine's spans (``repro_torch.serving.tracing``) on the CPU: none
and no CUDA event without a profiler session; under one, a paged step's
spans nest (``step`` over ``admit``, ``upload``, ``prefill``, ``decode``
and ``readback``) and its forwards carry their shapes; a decode-only
paged step makes four host syncs; a speculative step records ``verify``;
the recorder's buffer drops its oldest span and counts it."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import TINY
from repro_torch.config.base import ModelConfig
from repro_torch.serving import tracing
from repro_torch.serving.engine import ContinuousBatchingEngine

CHILDREN = {"admit", "upload", "prefill", "decode", "verify", "readback"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(**kw):
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    return ContinuousBatchingEngine(cfg, max_slots=3, max_seq=96,
                                    kv_layout="paged", token_budget=24,
                                    device="cpu", **kw)


def _submit(eng, lens=(20, 5, 33), max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [eng.submit(rng.integers(1, TINY.vocab_size, n), max_new)
            for n in lens]


def _traced(eng, n_steps):
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        for _ in range(n_steps):
            eng.step()
    return tracing.RECORDER.spans(eng)


def test_no_profiler_session_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("created while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing, "StepTrace", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    eng = _engine()
    _submit(eng)
    n = 0
    while eng.waiting or eng.active_slots:
        eng.step()
        n += 1
    assert n > 3 and not torch.autograd._profiler_enabled()
    assert tracing.RECORDER.spans(eng) == []
    assert eng._tr is None and eng._anchor is None
    assert eng.stats()["n_host_syncs"] > 0


def test_traced_paged_steps_nest_their_spans():
    eng = _engine()
    rids = _submit(eng)
    spans = _traced(eng, 6)
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == 6
    assert [s.attrs["iteration"] for s in steps] == sorted(
        s.attrs["iteration"] for s in steps)
    assert {s.name for s in spans} == CHILDREN - {"verify"} | {"step"}
    for s in spans:
        assert s.t0 <= s.t1 and s.engine == eng.span_key and s.dev is None
        if s.name == "step":
            assert s.parent == 0
            continue
        parent = by_id[s.parent]
        assert parent.name in ("step", "admit")
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1
    pre = [s for s in spans if s.name == "prefill"]
    assert {s.request for s in pre} == set(rids)
    assert sum(s.attrs["real"] for s in pre) == 20 + 5 + 33
    assert sum(s.attrs["last"] for s in pre) == 3
    for s in pre:
        a = s.attrs
        assert 0 <= a["real"] <= a["T"] and a["pad"] >= 0
    uploads = [s for s in spans if s.name == "upload"]
    assert all(s.attrs["bytes"] > 0 for s in uploads)
    for s in (s for s in spans if s.name == "decode"):
        a = s.attrs
        assert a["rows"] == 3 and len(a["contexts_active"]) <= 3
        assert all(c - r >= 0 for c, r in zip(a["contexts_active"],
                                              a["real_contexts"]))
    # off again: the next step records nothing
    n = len(tracing.RECORDER.spans(eng))
    eng.step()
    assert len(tracing.RECORDER.spans(eng)) == n


def test_decode_only_paged_step_makes_four_host_syncs():
    eng = _engine()
    _submit(eng, max_new=20)
    while eng.waiting or eng.prefilling_slots:
        eng.step()
    assert len(eng.decoding_slots) == 3
    before = eng.stats()
    eng.step()
    after = eng.stats()
    # tokens, positions, block tables up; the sampled tokens back
    assert after["n_host_syncs"] - before["n_host_syncs"] == 4
    assert after["n_iters"] - before["n_iters"] == 1
    assert after["n_spans_dropped"] == before["n_spans_dropped"]


def test_speculative_engine_records_verify_spans():
    eng = _engine(spec_k=2)
    _submit(eng, lens=(12, 12, 12), max_new=10)
    spans = _traced(eng, 8)
    ver = [s for s in spans if s.name == "verify"]
    assert ver and not [s for s in spans if s.name == "decode"]
    for s in ver:
        assert s.attrs == {"rows": 3, "width": 3}
        # each verify forward is followed by its one readback
        after = [r for r in spans if r.name == "readback"
                 and r.parent == s.parent and r.t0 >= s.t1]
        assert after


def test_recorder_drops_the_oldest_and_counts():
    rec = tracing.Recorder(capacity=3)
    for i in range(5):
        rec.add(tracing.Span("step", i + 1, 0, 7, float(i), float(i)))
    assert [s.id for s in rec.spans()] == [3, 4, 5]
    assert rec.n_dropped == 2
    assert rec.spans(engine=_engine()) == []


def test_piece_counts_positions_past_the_padding():
    # a 20-token prompt in a 32 bucket: 12 positions of padding
    assert tracing.piece(16, 0, 12, 32) == {
        "T": 16, "start": 0, "pad": 12, "real": 4, "last": False}
    assert tracing.piece(16, 16, 12, 32)["real"] == 16
    assert tracing.piece(8, 0, 12, 32)["real"] == 0
    assert tracing.piece(2, 30, 12, 32)["last"]
