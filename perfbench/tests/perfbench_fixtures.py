"""Fixtures and helpers of the benchmark's tests, imported by each test
module (a module of its own name: a second ``conftest`` beside the
repository's would shadow it). Tests that need the card take the
``card`` fixture and carry the ``card`` marker; the fixture decides at
run time, never at import, and skips where no CUDA device is visible.
On the card they run with ``python3 -m pytest -m card perfbench/tests``."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


#: a tiny decoder of each family the benchmark serves, on the CPU
FAMILIES = {
    "tiny-glm": {"registry": "chatglm3-6b", "rope": "rope2d",
                 "rope_theta": 10000.0},
    "tiny-yi": {"registry": "yi-34b", "rope": "rope",
                "rope_theta": 5000000.0},
}


def tiny_config(family, **over):
    conf = {"name": family, "n_layers": 2, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 512,
            "activation": "silu", "norm": "rmsnorm", "norm_eps": 1e-6,
            "tie_embeddings": False, "reduced": [], **FAMILIES[family]}
    conf.update(over)
    return conf


#: the open loop's per-layer metrics: (name, unit, source)
OPEN_LOOP_PER_LAYER = (
    ("ttft_p90_ms.chat", "ms", "host_clock"),
    ("ttft_mean_ms.chat", "ms", "host_clock"),
    ("itl_p95_ms.chat", "ms", "host_clock"),
    ("arrival_lag_p99_ms.chat", "ms", "host_clock"),
    ("queue_wait_p90_ms.chat", "ms", "host_clock"),
    ("prefill_pieces_per_step.chat", "pieces", "program_counter"),
    ("step_ms.chat", "ms", "host_clock"),
    ("mfu.chat", "%", "device_trace"),
    ("device_idle.chat", "%", "device_trace"),
)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with tiny CPU cells beside the real ones
    (torch on two threads meanwhile): ``tiny-yi.tinybatch`` (closed
    queue), listed by every metric of the batch cells, and
    ``tiny-glm.tinychat`` (open loop) with the open loop's metrics."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "perfbench"
    for name in FAMILIES:
        (base / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
    (base / "traffic" / "tinychat.json").write_text(json.dumps({
        "loop": "open", "rate": {"share_of_knee": 0.75},
        "prompt": {"median": 24, "sigma": 0.7, "min": 4, "max": 60},
        "output": {"median": 12, "sigma": 0.6, "min": 2, "max": 30},
        "lead_in_s": 0.3, "tail_s": 5.0}))
    (base / "traffic" / "tinybatch.json").write_text(json.dumps({
        "loop": "closed",
        "prompt": {"median": 24, "sigma": 0.3, "min": 16, "max": 60},
        "output": {"median": 12, "sigma": 0.6, "min": 2, "max": 30},
        "cycle": 16, "lead_in_s": 0.2}))
    # a handful of tokens: on a loaded CPU a 1-s window finishes few
    check = {"logit_gap": 1e-3, "tokens": 8, "max_requests": 8}
    for cell, eng in (("tiny-glm.tinychat", (4, 32)),
                      ("tiny-yi.tinybatch", (8, 64))):
        (base / "cells" / f"{cell}.json").write_text(json.dumps({
            "engine": {"kv_layout": "paged", "block_size": 16,
                       "max_slots": eng[0], "max_seq": 128,
                       "token_budget": eng[1]},
            "knee_rps": 40.0, "preadmit": 2, "check": check}))
        conf, mix = cell.split(".")
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and any(w.endswith(".batch") for w in ws):
            ws.append("tiny-yi.tinybatch")
    # the benchmark has no open-loop cell yet: the open loop's metrics
    # (readers under perfbench/metrics) list the tiny one
    chat = ["tiny-glm.tinychat"]
    bench["end_to_end"].insert(0, {
        "name": "itl_mean_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": chat})
    for name, unit, source in OPEN_LOOP_PER_LAYER:
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower", "source": source,
            "layer": "engine", "moves": "itl_mean_ms", "workloads": chat})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (tmp_path / "src").symlink_to(ROOT / "src")
    # two threads: the test workers share the CPU, and a tiny cell's
    # window must still finish requests there
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield tmp_path
    finally:
        torch.set_num_threads(threads)
