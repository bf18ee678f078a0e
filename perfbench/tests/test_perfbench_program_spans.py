"""The readers of the program's spans and counters
(``perfbench/metrics/{idle_in_forward,idle_between_forwards,
host_syncs_per_step,decode_device_ms,prefill_device_us_per_token}.py``):
none on a CPU traced run, the hand-computed values on a hand-built trace,
the program's forward records equal to the harness's on the tiny batch
cell, and (on the card) the forwards' device intervals holding the
model's kernels and the idle split adding up to ``device_idle``."""
import bisect
import importlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench_fixtures import ROOT, card, tiny_root  # noqa: F401
from perfbench.harness import bench
from perfbench.harness.serve import Driver, Spans, Stamps, Window
from perfbench.harness.trace import DeviceTrace
from repro_torch.serving import tracing

BATCH = "tiny-yi.tinybatch"
READERS = ("idle_in_forward", "idle_between_forwards", "host_syncs_per_step",
           "decode_device_ms", "prefill_device_us_per_token")


def _reader(stem):
    return importlib.import_module(f"perfbench.metrics.{stem}")


def test_readers_report_nothing_on_a_cpu_traced_run(tiny_root):
    res = bench.run_cell(tiny_root, BATCH, 2**31 + 11, 1.0, True, "cpu")
    assert res["correct"] is True
    assert not {f"{r}.batch" for r in READERS} & set(res["metrics"])


def _hand_built(dropped=0):
    """A 10-s window: two steps, three forwards (the last without a
    device interval), seven kernels, the program's counters."""
    trace = DeviceTrace("cpu")
    trace.t0, trace.t1, trace.stopped = 0.0, 10.0, True
    trace.kernels = [("k1", 1.2, 0.5), ("k2", 2.0, 1.0), ("k3", 2.5, 0.2),
                     ("k4", 3.4, 0.1), ("k5", 5.6, 1.0), ("k6", 6.8, 0.5),
                     ("k7", 8.0, 0.3)]
    rec = tracing.Recorder()

    def add(name, id_, parent, t0, t1, dev=None, **attrs):
        rec.add(tracing.Span(name, id_, parent, 1, t0, t1, attrs=attrs,
                             dev=dev))

    add("upload", 2, 1, 0.6, 0.7, bytes=4)
    add("decode", 3, 1, 1.0, 3.0, (1.2, 3.5), rows=2)
    add("readback", 4, 1, 3.0, 3.6)
    add("step", 1, 0, 0.5, 4.5)
    add("prefill", 6, 5, 5.5, 7.0, (5.6, 7.5), real=10)
    add("decode", 7, 5, 7.5, 8.5, rows=2)
    add("step", 5, 0, 5.0, 9.0)
    win = Window(trace=trace, stats={
        "trace_start": {"n_iters": 10.0, "n_host_syncs": 40.0,
                        "n_spans_dropped": 0.0},
        "trace_end": {"n_iters": 12.0, "n_host_syncs": 49.0,
                      "n_spans_dropped": float(dropped)}})
    return bench.Run(None, 16, 0.0, win, Stamps(), None), rec


def test_readers_on_a_hand_built_trace(monkeypatch):
    run, rec = _hand_built()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    got = {r: _reader(r).read(run) for r in READERS}
    # idle gaps: [0, 1.2] in step 1 outside forwards, [1.7, 2.0] in its
    # decode, [3.0, 3.4] in its readback, [3.5, 5.6] and [8.3, 10]
    # between steps, [6.6, 6.8] in the prefill, [7.3, 8.0] in step 2's
    # decode
    assert got["idle_in_forward"] == pytest.approx(100 * 1.2 / 10)
    assert got["idle_between_forwards"] == pytest.approx(100 * 1.6 / 10)
    assert _reader("device_idle").read(run) == pytest.approx(66.0)
    assert got["host_syncs_per_step"] == pytest.approx(4.5)
    # k1..k4 start inside the decode's interval, k2 and k3 overlap; the
    # second decode has no interval
    assert got["decode_device_ms"] == pytest.approx(1600.0)
    assert got["prefill_device_us_per_token"] == pytest.approx(1.5e6 / 10)


def test_readers_refuse_dropped_spans_and_an_older_program(monkeypatch):
    run, rec = _hand_built(dropped=3)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    for r in READERS:
        want = 4.5 if r == "host_syncs_per_step" else None
        assert _reader(r).read(run) == want, r
    # a program without spans or the counter: every reader reads None
    run, _ = _hand_built()
    for side in run.window.stats.values():
        del side["n_host_syncs"], side["n_spans_dropped"]
    import repro_torch.serving
    monkeypatch.delattr(repro_torch.serving, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.serving.tracing", None)
    assert all(_reader(r).read(run) is None for r in READERS)


def test_program_forward_records_equal_the_harness(tiny_root):
    """The program's ``prefill`` and ``decode`` spans carry what the
    harness's ``Spans`` records of the same forwards."""
    c, _, engine, _ = bench.setup(tiny_root, BATCH, 5, torch.device("cpu"))
    stamps = Stamps()
    spans = Spans(engine, stamps)
    driver = Driver(engine, stamps, spans)
    from perfbench.traffic.generator import Schedule
    for r in Schedule(c.mix, 5, c.config["vocab_size"]).preadmit(12):
        driver.submit(r, 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        while engine.waiting or engine.active_slots:
            driver.step()
    prog = [s for s in tracing.RECORDER.spans(engine)
            if s.name in ("prefill", "decode")]
    assert len(prog) == len(spans.forwards) > 12
    assert sum(s.name == "prefill" for s in prog) >= 12
    keys = {"prefill": ("T", "start", "pad", "real", "last"),
            "decode": ("rows", "contexts_active", "real_contexts")}
    for s, f in zip(prog, spans.forwards):
        assert s.name == f["kind"]
        assert {k: s.attrs[k] for k in keys[s.name]} == \
            {k: f[k] for k in keys[s.name]}
        assert s.t0 <= f["t0"] and f["t1"] <= s.t1


@pytest.mark.card
def test_program_spans_on_the_card(card, monkeypatch):
    """A short traced window of ``yi-34b-l15.batch``: the profiler's CUDA
    session turns the program's tracing on; the GEMM and paged-attention
    kernels lie inside the forwards' device intervals; the two idle
    shares add up to ``device_idle`` within half a point."""
    probe = DeviceTrace(card)
    probe.start()
    on = torch.autograd._profiler_enabled()
    probe.stop()
    assert on
    runs = []

    class Kept(bench.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(bench, "Run", Kept)
    res = bench.run_cell(ROOT, "yi-34b-l15.batch", 2**31 + 4242, 8.0, True,
                         card)
    # a short window finishes too few requests for the run's token count;
    # every served token checked is still the reference's argmax
    gap = res["checks"]["logit_gap"]
    assert gap["value"] is not None and gap["value"] <= gap["limit"]
    run, m = runs[0], res["metrics"]
    spans = _reader("idle_in_forward").program_spans(run)
    fw = [s for s in spans if s.name in ("prefill", "decode")]
    dev = sorted(s.dev for s in fw if s.dev is not None)
    # only the first traced step has no anchor
    first = min((s for s in spans if s.name == "step"), key=lambda s: s.t0)
    unplaced = {s.parent for s in fw if s.dev is None}
    starts = [d[0] for d in dev]
    share = {}
    for cls in ("gemm", "paged_decode", "paged_prefill"):
        pats = run.cell.kernel_patterns(cls)
        inside = total = 0.0
        for name, s, d in run.trace.kernels:
            if s < dev[0][0] or not any(p in name.lower() for p in pats):
                continue
            total += d
            j = bisect.bisect_right(starts, s) - 1
            if j >= 0 and s <= dev[j][1]:
                inside += d
        share[cls] = inside / total
    split = m["idle_in_forward.batch"]["value"] \
        + m["idle_between_forwards.batch"]["value"]
    print("card:", {k: v["value"] for k, v in m.items()}, share,
          len(dev), len(fw), file=sys.stderr)
    assert unplaced <= {first.id}
    assert min(share.values()) >= 0.99, share
    assert abs(split - m["device_idle.batch"]["value"]) <= 0.5
