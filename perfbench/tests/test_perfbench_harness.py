"""The harness on the CPU at tiny sizes: what a run loads, what its last
line carries, that new cells, mixes, metrics and kernel classes are
found by name, and that a broken timed path comes out not correct."""
import hashlib
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from perfbench_fixtures import ROOT, tiny_config, tiny_root  # noqa: F401
from perfbench.harness import bench, cell
from perfbench.harness.check import FORBIDDEN

CHAT, BATCH = "tiny-glm.tinychat", "tiny-yi.tinybatch"
KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks")


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_a_run_loads_no_jax_and_no_reference_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, '.'); "
        "from perfbench.harness import bench, check; "
        f"r = bench.run_cell('.', {CHAT!r}, 2**31 + 3, 1.0, False, 'cpu'); "
        "tops = sorted({m.split('.')[0] for m in sys.modules}); "
        "print(check.forbidden_modules(), 'repro_torch' in tops, "
        "r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    # whole top-level names: repro_torch is loaded, repro is not
    assert out.stdout.split("\n")[-2] == "[] True True"
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("workload", [CHAT, BATCH])
def test_last_line_and_checks(tiny_root, workload):
    res = bench.run_cell(tiny_root, workload, 7, 1.0, False, "cpu")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        bench.emit(res)
    line = json.loads(out.getvalue().strip().split("\n")[-1])
    assert set(line) <= set(KEYS)
    assert list(line)[:5] == list(KEYS[:5])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {"setup_s", "itl_mean_ms"} if workload == CHAT \
        else {"setup_s", "tokens_s"}
    assert set(line["metrics"]) == want
    tail = err.getvalue().strip().split("\n")[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)


def test_traced_run_reads_per_layer_metrics_only(tiny_root):
    res = bench.run_cell(tiny_root, CHAT, 9, 1.0, True, "cpu")
    # on the CPU no device trace: the host-clock readers alone report
    assert set(res["metrics"]) == {"arrival_lag_p99_ms.chat",
                                   "queue_wait_p90_ms.chat",
                                   "ttft_p90_ms.chat", "ttft_mean_ms.chat",
                                   "itl_p95_ms.chat"}
    assert res["correct"] is True


def test_forward_records_count_prompts_past_their_padding(tiny_root):
    """A traced run's forward records: the prefill pieces' ``real``
    positions add up to the prompts, one piece a prompt is its last, and
    each decoding row's real context is its context less its padding."""
    import torch
    from perfbench.harness.serve import Driver, Spans, Stamps
    from perfbench.traffic.generator import Schedule, padded_len
    c, _, engine, _ = bench.setup(tiny_root, BATCH, 5, torch.device("cpu"))
    stamps = Stamps()
    spans = Spans(engine, stamps)
    driver = Driver(engine, stamps, spans)
    reqs = Schedule(c.mix, 5, c.config["vocab_size"]).preadmit(12)
    for r in reqs:
        driver.submit(r, 0.0)
    while engine.waiting or engine.active_slots:
        driver.step()
    pre = [f for f in spans.forwards if f["kind"] == "prefill"]
    dec = [f for f in spans.forwards if f["kind"] == "decode"]
    assert sum(f["real"] for f in pre) == sum(len(r.prompt) for r in reqs)
    assert sum(f["last"] for f in pre) == len(reqs)
    assert all(0 <= f["real"] <= f["T"] for f in pre)
    assert any(f["pad"] for f in pre)
    pads = {padded_len(len(r.prompt)) - len(r.prompt) for r in reqs}
    for f in dec:
        assert len(f["contexts_active"]) <= f["rows"]
        for ctx, real in zip(f["contexts_active"], f["real_contexts"]):
            assert ctx - real in pads and real >= 1


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_metric_and_kernel_class_found_by_name(tiny_root):
    before = _digests(tiny_root)
    base = tiny_root / "perfbench"
    (base / "configs" / "tiny-new.json").write_text(json.dumps(
        tiny_config("tiny-yi", name="tiny-new", n_layers=3)))
    (base / "traffic" / "tinyshort.json").write_text(json.dumps({
        "loop": "open", "rate": {"share_of_knee": 0.5},
        "prompt": {"median": 8, "sigma": 0.5, "min": 2, "max": 16},
        "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
        "lead_in_s": 0.2, "tail_s": 3.0}))
    (base / "cells" / "tiny-new.tinyshort.json").write_text(json.dumps({
        "engine": {"kv_layout": "paged", "block_size": 16, "max_slots": 4,
                   "max_seq": 64, "token_budget": 16},
        "knee_rps": 40.0, "preadmit": 1,
        "check": {"logit_gap": 1e-3, "tokens": 16, "max_requests": 8}}))
    (base / "metrics" / "requests_due.py").write_text(
        "def read(run):\n    return len(run.window.window_rids)\n")
    (base / "kernel_classes" / "norms.json").write_text(json.dumps(
        {"what": "RMSNorm reductions", "patterns": ["reduce_kernel"]}))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-new", "source": "tiny",
                         "file": "perfbench/configs/tiny-new.json",
                         "reduced": [], "why": "a new file"})
    b["workloads"].append({"name": "tiny-new.tinyshort",
                           "config": "tiny-new", "traffic": "tinyshort",
                           "chips": 1, "why": "a new cell"})
    b["end_to_end"].insert(0, {
        "name": "requests_due", "unit": "requests", "better": "higher",
        "bound": 0.01, "source": "host_clock",
        "workloads": ["tiny-new.tinyshort"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))

    c = cell.load(tiny_root, "tiny-new.tinyshort")
    assert c.config["n_layers"] == 3 and bench.rate_of(c) == 20.0
    assert c.kernel_patterns("norms") == ["reduce_kernel"]
    assert [m.name for m in c.end_to_end] == ["requests_due", "setup_s"]
    res = bench.run_cell(tiny_root, "tiny-new.tinyshort", 3, 1.0, False,
                         "cpu")
    assert res["metrics"]["requests_due"]["value"] == 20.0
    assert res["correct"] is True
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(cell.CellError):
        cell.load(tiny_root, "no-such.cell")


def _alter_tokens(monkeypatch, every):
    """The timed path's fault: every ``every``-th token the engine samples
    is replaced by the next id, where it is produced."""
    import repro_torch.serving.engine as eng
    orig = eng.sample_tokens
    calls = [0]

    def altered(logits, greedy=True, seed=0):
        out = orig(logits, greedy, seed)
        calls[0] += 1
        if calls[0] % every == 0:
            out = (out + 1) % logits.shape[-1]
        return out

    def hook(engine):
        monkeypatch.setattr(eng, "sample_tokens", altered)

    return hook


@pytest.mark.parametrize("workload", [CHAT, BATCH])
def test_an_altered_token_makes_the_run_not_correct(tiny_root, monkeypatch,
                                                    workload):
    """The harness's look for a chip is skipped (device 'cpu'); the rest
    of a run goes as on the card, with the tokens altered underneath."""
    res = bench.run_cell(tiny_root, workload, 11, 2.0, False, "cpu",
                         hook=_alter_tokens(monkeypatch, 5))
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] \
        > res["checks"]["logit_gap"]["limit"]


def test_run_py_prints_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "chatglm3-6b.batch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_prints_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would go ahead")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "chatglm3-6b.batch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_every_metric_has_a_reader_and_every_class_a_file():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in b["workloads"]]
    for w in names:
        c = cell.load(ROOT, w)
        assert c.end_to_end and c.per_layer
        assert "setup_s" in [m.name for m in c.end_to_end]
    for cls in ("gemm", "paged_decode", "paged_prefill"):
        assert (ROOT / "perfbench" / "kernel_classes"
                / f"{cls}.json").is_file()
