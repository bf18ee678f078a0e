"""The plain reference against the program's engine, on the CPU at a
tiny width: every logit the engine computed for a served position (the
last prefill piece's and each decode step's) within rounding of the
reference's full forward, and the reference in TF32 or in bfloat16
outside that tolerance."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench_fixtures import ROOT, tiny_config
from perfbench.harness.bench import import_program, model_config
from perfbench.harness.check import sequence
from perfbench.harness.weights import make_params
from perfbench.reference.model import logits, round_tf32

#: float32 against float32 in another order: the engine's worst logit
#: gap at these sizes is about 2e-7 (logits of std 0.16-0.23); TF32
#: moves them by 7e-4 to 1.2e-3 and bfloat16 by 5e-3 to 1e-2
TOL = 2e-5


def _captured(engine):
    """Wrap the engine's model so that each logit row it computes for a
    served position is kept as (request id, position, row)."""
    rows = []
    model = engine.model
    prefill, decode = model.prefill_chunk, model.decode_step

    def prefill_chunk(params, cache, batch):
        s = engine.slots[engine.prefilling_slots[0]]
        T = batch["tokens"].shape[1]
        out = prefill(params, cache, batch)
        if s.prefill_pos + T == len(s.seq_tokens):
            rows.append((s.request_id, s.prefill_pos + T - 1,
                         out[0][0, -1].clone()))
        return out

    def decode_step(params, cache, batch):
        act, pos = list(engine.decoding_slots), engine.pos.copy()
        out = decode(params, cache, batch)
        rows.extend((engine.slots[i].request_id, int(pos[i]),
                     out[0][i, -1].clone()) for i in act)
        return out

    model.prefill_chunk, model.decode_step = prefill_chunk, decode_step
    return rows


CASES = [("tiny-glm", {}), ("tiny-yi", {}),
         ("tiny-glm", dict(d_model=128, n_heads=8, vocab_size=2048,
                           n_layers=3))]


@pytest.mark.parametrize("name,over", CASES,
                         ids=["glm-rope2d", "yi-rope", "glm-wider"])
def test_engine_logits_match_reference_and_controls_do_not(name, over):
    get_config, Engine = import_program(ROOT)
    conf = tiny_config(name, **over)
    params = make_params(conf, 5, "cpu")
    # a 24-token budget cuts every prompt into power-of-two pieces
    eng = Engine(model_config(get_config, conf), max_slots=3, max_seq=128,
                 kv_layout="paged", block_size=16, token_budget=24,
                 device="cpu", params=params)
    rows = _captured(eng)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, conf["vocab_size"], n).astype(np.int32)
               for n in (5, 17, 40, 9, 33)]
    results = eng.run(prompts, max_new_tokens=12)
    worst = {"program": 0.0, "tf32": float("inf"), "bf16": float("inf")}
    n_rows = 0
    for r in results:
        seq, first = sequence(prompts[r.request_id],
                              np.append(r.tokens, 0))
        toks = torch.as_tensor(seq)
        ref = logits(conf, params, toks, 0, "fp32")
        mine = [(p, row) for rid, p, row in rows if rid == r.request_id]
        assert [p for p, _ in mine] == list(range(first, len(seq)))
        for p, row in mine:
            worst["program"] = max(worst["program"],
                                   float((row - ref[p]).abs().max()))
        n_rows += len(mine)
        for mode in ("tf32", "bf16"):
            ctl = logits(conf, params, toks, first, mode)
            worst[mode] = min(worst[mode], float(
                (ctl - ref[first:]).abs().max()))
        # the served tokens are the reference's argmax
        n = len(r.tokens)
        assert torch.equal(ref[first:first + n].argmax(-1),
                           torch.as_tensor(r.tokens).long())
    # one row a served token, and the last decode step's (unused) row
    assert n_rows == len(rows) == sum(len(r.tokens) + 1 for r in results)
    assert worst["program"] <= TOL
    assert worst["tf32"] > TOL and worst["bf16"] > TOL


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0])
    got = round_tf32(x)
    assert got[0] == 1.0 + 2 ** -10
    assert got[1] == 1.0 + 2 ** -10  # rounds up past the 10th bit
    assert got[2] == 3.0
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro", "repro_torch", "jax",
                                             "jaxlib", "flax"), (path, mod)
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    tops = set(eval(out))
    assert not tops & {"repro", "repro_torch", "jax", "jaxlib", "flax"}
