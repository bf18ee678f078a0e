"""The port's paged continuous-batching engine against the JAX engine,
on the CPU, plus the port's package rules.

Both engines get the same weights (the JAX engine's ``params``, bridged)
and the same submit/step schedule; their greedy token streams must be
identical, and after every step the port's allocator must conserve its
blocks (``n_free + n_live == n_blocks``, disjoint sets, no null block,
one owner per block, block tables mirroring the slots), as
tests/test_engine_fuzz.py checks for the reference.

Also here: the no-jax import guard (in a subprocess, since this
process imported jax through conftest.py), the device policy (no GPU and
no ``device`` argument raises), the features the port still refuses (and
those it now serves as the reference does), the
prefix cache's gate, hybrid stacks under the paged layout, and
``chip_smoke.py``'s refusal to run without a GPU or outside a checkout.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS, TINY
from repro.config import get_reduced_config
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config.base import ModelConfig
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.engine import BlockAllocator, ContinuousBatchingEngine

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores,
    and torch's default pool (one thread per core) would starve the
    other workers' timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _check_invariants(eng, ctx: str) -> None:
    al = eng.allocator
    free, live = set(al._free), set(al._outstanding)
    assert not free & live, f"{ctx}: allocator id sets overlap"
    assert len(free) + len(live) == al.n_blocks == al.n_free + al.n_live, \
        f"{ctx}: conservation broken"
    assert al.n_available >= 0, f"{ctx}: n_available < 0"
    mapped = [b for s in eng.slots if s.active for b in s.blocks]
    assert len(mapped) == len(set(mapped)), f"{ctx}: block owned twice"
    assert 0 not in mapped, f"{ctx}: null block mapped"
    assert set(mapped) == live, f"{ctx}: live blocks != mapped blocks"
    reserved = sum(s.n_outstanding for s in eng.slots if s.active)
    assert reserved == al.n_reserved, f"{ctx}: reservations drifted"
    for i, s in enumerate(eng.slots):
        if s.active and not s.prefilling:
            n = len(s.blocks)
            np.testing.assert_array_equal(eng.block_tables[i, :n], s.blocks,
                                          err_msg=ctx)
            assert not eng.block_tables[i, n:].any(), ctx
        else:
            assert not eng.block_tables[i].any(), ctx


SCHEDULES = {
    # (config, max_slots, max_seq, token_budget, kv_blocks, prompt lens,
    #  max_new, submit-at-step)
    "tiny-budget": (TINY, 2, 64, 12, None, (5, 17, 30, 3, 9), 5,
                    (0, 0, 1, 3, 3)),
    "qwen3-uncapped": (get_reduced_config("qwen3-0.6b"), 3, 96, None, None,
                       (40, 2, 60, 15), 6, (0, 1, 1, 4)),
    "qwen3-tight-blocks": (get_reduced_config("qwen3-0.6b"), 3, 80, 20, 7,
                           (20, 33, 6, 50, 11), 7, (0, 0, 0, 2, 2)),
    "tail-budget": (KIND_CFGS["tail"], 2, 64, 9, None, (8, 25, 14), 4,
                    (0, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_engine_token_streams_match_reference(name):
    """Same weights, same submit/step schedule: identical greedy tokens
    per request, finishing at the same step; allocator invariants after
    every step; nothing leaks after the drain."""
    cfg, slots, max_seq, budget, blocks, lens, max_new, at = SCHEDULES[name]
    je = JaxEngine(cfg, max_slots=slots, max_seq=max_seq, kv_layout="paged",
                   token_budget=budget, kv_blocks=blocks)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=slots,
                                  max_seq=max_seq, kv_layout="paged",
                                  token_budget=budget, kv_blocks=blocks,
                                  device="cpu")
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    done = {"jax": {}, "torch": {}}
    step = 0
    while step < 200:
        for p, t in zip(prompts, at):
            if t == step:
                assert je.submit(p, max_new) == te.submit(p, max_new)
        for tag, eng in (("jax", je), ("torch", te)):
            for r in eng.step():
                done[tag][r.request_id] = (step, r.tokens.tolist(),
                                           r.truncated)
        _check_invariants(te, f"{name} step {step}")
        assert te.n_prefill_chunk_tokens == je.n_prefill_chunk_tokens
        step += 1
        if step > max(at) and not (je.waiting or je.active_slots):
            break
    assert len(done["jax"]) == len(prompts)
    assert done["torch"] == done["jax"]
    assert not (te.waiting or te.active_slots)
    assert te.allocator.n_live == 0 and te.allocator.n_reserved == 0
    assert te.n_iters == je.n_iters
    assert te.stats()["n_prefill_chunks"] == te.n_prefill_chunks > 0


def test_allocator_rejects_double_free_and_foreign_ids():
    al = BlockAllocator(4, 8)
    assert al.reserve(3) and not al.reserve(2)
    a, b = al.alloc_reserved(), al.alloc_reserved()
    assert {a, b} == {1, 2} and al.n_available == 1
    for bad in ([a, a], [0], [5], [3]):
        with pytest.raises(ValueError):
            al.free(bad)
    al.free([a])
    with pytest.raises(ValueError, match="double free"):
        al.free([a])
    al.free([b])
    al.unreserve(1)
    assert al.n_free == 4 and al.n_live == 0 and al.n_reserved == 0


def test_submit_validates_prompt_bounds():
    """Token ids are checked on the host at the boundary (the model's
    embedding would raise, and the reference would fill NaN rows)."""
    eng = ContinuousBatchingEngine(_torch_cfg(TINY), max_slots=1,
                                   max_seq=32, kv_layout="paged",
                                   device="cpu")
    for bad in ([1, TINY.vocab_size], [-1, 2]):
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(np.asarray(bad, np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(np.ones(40, np.int32))
    eng.submit(np.ones(3, np.int32), max_new_tokens=100)
    res = eng.run([], max_new_tokens=1)
    assert res[0].truncated and len(res[0].tokens) == 32 - 16


@pytest.mark.parametrize("kw", [
    {"kv_layout": "dense", "spec_k": 2},
    {"spec_k": 2}, {"kv_host_blocks": 4}, {"mesh": object()}])
def test_unported_engine_features_raise(kw):
    """Speculation (both layouts), the host tier and tensor parallelism (a
    mesh) are ported: the engine builds as the reference's does. The mesh
    case spans one device on both sides (this process has one jax
    device; tests/test_torch_tp_engine.py runs tp = 2 and 4), and a mesh
    that is not a mesh fails as the reference's does."""
    kw = {"kv_layout": "paged", **kw}
    if "mesh" in kw:
        for eng, args in ((JaxEngine, {}),
                          (ContinuousBatchingEngine, {"device": "cpu"})):
            with pytest.raises(AttributeError, match="axis_names"):
                eng(TINY if eng is JaxEngine else _torch_cfg(TINY),
                    **args, **kw)
        from repro.launch.mesh import make_tp_mesh as jax_mesh
        from repro_torch.launch.mesh import make_tp_mesh
        je = JaxEngine(TINY, max_slots=2, max_seq=64, kv_layout="paged",
                       mesh=jax_mesh(1))
        te = ContinuousBatchingEngine(_torch_cfg(TINY), max_slots=2,
                                      max_seq=64, kv_layout="paged",
                                      mesh=make_tp_mesh(1, ["cpu"]),
                                      device="cpu")
        te.load_jax_params(jax.tree.map(np.asarray, je.params))
        assert te.tp_degree == je.tp_degree == 1
        prompt = np.arange(1, 12, dtype=np.int32)
        assert [r.tokens.tolist() for r in te.run([prompt], 6)] == \
            [r.tokens.tolist() for r in je.run([prompt], 6)]
        return
    je = JaxEngine(TINY, max_slots=2, max_seq=64, **kw)
    te = ContinuousBatchingEngine(_torch_cfg(TINY), max_slots=2, max_seq=64,
                                  device="cpu", **kw)
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    assert (te.spec_max, te.kv_host_blocks, te.swap_ok) == \
        (je.spec_max, je.kv_host_blocks, je.swap_ok)
    prompts = [np.arange(1, n, dtype=np.int32) for n in (5, 12)]
    assert [r.tokens.tolist() for r in te.run(prompts, 6)] == \
        [r.tokens.tolist() for r in je.run(prompts, 6)]


@pytest.mark.parametrize("kind,kw", [
    ("global", {"kv_layout": "dense"}), ("global", {"kv_layout": "paged"}),
    ("tail", {"kv_layout": "paged", "token_budget": 8})])
def test_prefix_cache_gate_is_the_references(kind, kw):
    """The prefix cache needs the paged layout (else the reference's
    ValueError); on a stack that pages every layer it builds and serves
    the reference's tokens with its hits."""
    cfg = KIND_CFGS[kind]
    if kw["kv_layout"] == "dense":
        for ctor, c in ((JaxEngine, cfg), (ContinuousBatchingEngine,
                                           _torch_cfg(cfg))):
            with pytest.raises(ValueError, match="kv_layout='paged'"):
                ctor(c, max_seq=64, prefix_cache=True,
                     **({"device": "cpu"} if c is not cfg else {}))
        return
    rng = np.random.default_rng(9)
    head = rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        1, cfg.vocab_size, 5).astype(np.int32)]) for _ in range(3)]
    got, want = _serve_pair(cfg, prompts, prefix_cache=True, block_size=8,
                            sequential=True, **kw)
    assert got == want
    assert want[1]["n_prefix_hits"] == 1.0


def _serve_pair(cfg, prompts, sequential=False, max_new=4, **kw):
    """The reference's and the port's engine (bridged weights, ``kw``)
    over ``prompts``, all at once or one run after another: (the port's
    [tokens..., stats subset], the reference's)."""
    je = JaxEngine(cfg, max_slots=2, max_seq=64, **kw)
    te = ContinuousBatchingEngine(_torch_cfg(cfg), max_slots=2, max_seq=64,
                                  device="cpu", **kw)
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    keys = ("n_prefix_hits", "prefix_hit_rate", "kv_allocated_tokens",
            "kv_cached_tokens")
    out = []
    for eng in (te, je):
        runs = [[p] for p in prompts] if sequential else [prompts]
        rows = []
        for batch in runs:
            res = eng.run(batch, max_new_tokens=max_new)
            st = eng.stats()
            rows.append({"tokens": [r.tokens.tolist() for r in res],
                         **{k: st[k] for k in keys}})
        out.append(rows)
    return out[0], out[1]


@pytest.mark.parametrize("kind", ["windowed", "rglru", "rwkv", "swa"])
def test_non_attention_layer_kinds_raise(kind):
    """Under the paged layout a windowed or recurrent stack keeps its
    rings and per-slot states beside the (empty or partial) block pool:
    it builds and serves the reference's paged engine's tokens with the
    same block accounting. What still raises is the prefix cache on it,
    the reference's ValueError, since it cannot share per-slot state."""
    cfg = KIND_CFGS[kind]
    with pytest.raises(ValueError, match="prefix_cache needs every layer"):
        ContinuousBatchingEngine(_torch_cfg(cfg), kv_layout="paged",
                                 prefix_cache=True, device="cpu")
    rng = np.random.default_rng(len(kind))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 11)]
    got, want = _serve_pair(cfg, prompts, kv_layout="paged", block_size=8,
                            token_budget=10)
    assert got == want


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """No GPU and no ``device`` argument: the engine, serve_continuous and
    the CLI raise instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(_torch_cfg(TINY), kv_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_serve.serve_continuous(cfg=_torch_cfg(TINY), duration_s=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--engine", "--exec-mode", "continuous"])


def test_serve_continuous_serves_on_the_cpu_when_asked():
    stats = engine_serve.serve_continuous(cfg=_torch_cfg(TINY),
                                          duration_s=3.0, rps=30.0,
                                          token_budget=16, device="cpu")
    assert stats["served"] > 0 and stats["n_iters"] > 0
    assert stats["n_prefill_chunks"] >= stats["served"]


def test_cli_defaults_and_refusals(monkeypatch):
    """The CLI takes the reference CLI's defaults (round mode; the dense
    layout in continuous mode) and passes --device and the paged options
    through; without --engine it runs the simulator, whose agents need the
    GPU unless --device cpu."""
    seen = {}
    monkeypatch.setattr(engine_serve, "serve_continuous",
                        lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(engine_serve, "serve_round",
                        lambda *a, **kw: seen.update(round=True, **kw))
    serve_cli.main(["--engine", "--exec-mode", "continuous", "--device",
                    "cpu"])
    assert seen["kv_layout"] == "dense" and seen["device"] == "cpu"
    seen.clear()
    serve_cli.main(["--engine", "--exec-mode", "continuous", "--kv-layout",
                    "paged", "--device", "cpu", "--token-budget", "8",
                    "--kv-block-budget", "12"])
    assert seen["kv_layout"] == "paged" and seen["device"] == "cpu"
    assert seen["token_budget"] == 8 and seen["kv_block_budget"] == 12
    seen.clear()
    serve_cli.main(["--engine", "--device", "cpu"])
    assert seen == {"round": True, "device": "cpu"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main([])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_never_imports_jax_or_the_reference():
    """Importing every module of repro_torch (and chip_smoke.py) leaves
    jax, every ``repro.`` module and the reference's ``benchmarks`` out
    of sys.modules: run in a fresh interpreter, since this one imported
    jax through conftest.py. The scripts under ``examples_torch/`` import
    none of them either (their import statements, parsed)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"sys.path.insert(0, {ROOT!r}); import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in\n"
        "             ('jax', 'repro', 'benchmarks') or\n"
        "             m.startswith(('jax.', 'repro.', 'benchmarks.')))\n"
        "assert len(mods) >= 98, mods\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    examples = sorted(Path(ROOT, "examples_torch").glob("*.py"))
    assert len(examples) >= 4, examples
    for path in examples:
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        assert any(n.startswith("repro_torch") for n in names), path
        bad = [n for n in names if n in ("jax", "repro", "benchmarks")
               or n.startswith(("jax.", "repro.", "benchmarks."))]
        assert not bad, (path, bad)


def test_chip_smoke_fails_without_a_gpu_or_a_checkout(tmp_path):
    """The smoke test exits non-zero and prints no result line without a
    GPU, and in a directory holding chip_smoke.py alone."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(lone)):
        out = subprocess.run([sys.executable, script], env=_env(),
                             cwd=os.path.dirname(script),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
