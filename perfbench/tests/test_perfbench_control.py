"""The control of ``correct``: the reference in a lower precision, put in
the program's place at the same served positions, reads above the limit
that the program's own runs keep under.

On the CPU the cell is small (d 128, a 32,000-token vocabulary, two
layers) and only bfloat16 is sure to flip a served token there: TF32's
logit errors (about 1e-4 at this width) flip a token on some seeds, and
its gap is then about that error. The card test runs each cell of the
benchmark at its own size on three seeds and holds TF32 and bfloat16
above its limit (``python3 -m pytest -m card perfbench/tests``)."""
import json

import pytest

from perfbench_fixtures import ROOT, card, tiny_config, tiny_root  # noqa: F401
from perfbench import control

SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)


@pytest.fixture
def ctl_root(tiny_root):
    base = tiny_root / "perfbench"
    (base / "configs" / "tiny-ctl.json").write_text(json.dumps(
        tiny_config("tiny-glm", name="tiny-ctl", d_model=128, n_heads=8,
                    d_ff=256, vocab_size=32000)))
    (base / "cells" / "tiny-ctl.tinychat.json").write_text(json.dumps({
        "engine": {"kv_layout": "paged", "block_size": 16, "max_slots": 8,
                   "max_seq": 128, "token_budget": 32},
        "knee_rps": 40.0, "preadmit": 4,
        "check": {"logit_gap": 1e-3, "tokens": 192, "max_requests": 32}}))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny-ctl.tinychat", "config": "tiny-ctl",
                           "traffic": "tinychat", "chips": 1, "why": "x"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    return tiny_root


def test_control_fails_where_the_program_passes_cpu(ctl_root):
    got = control.readings(ctl_root, "tiny-ctl.tinychat", SEEDS, 3.0,
                           ("tf32", "bf16"), "cpu")
    for seed, r in got.items():
        assert r["tokens"] >= 192
        assert r["program"] <= r["limit"], (seed, r)
        assert r["bf16"] > r["limit"], (seed, r)
        assert r["tf32"] >= r["program"], (seed, r)


@pytest.mark.card
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"]])
def test_control_fails_at_the_cells_size(card, workload):
    got = control.readings(ROOT, workload, (4101, 4102, 4103), 30.0,
                           ("tf32", "bf16"), card)
    for seed, r in got.items():
        assert r["program"] <= r["limit"], (seed, r)
        assert min(r["tf32"], r["bf16"]) > r["limit"], (seed, r)
