"""The port's engine figures (paged KV, chunked preemption, prefix cache,
multi-model concurrency) against the reference's ``benchmarks/`` at the
smoke profile, on the CPU; and the runner ``repro_torch.figures.run``.

The reference runs once, in a subprocess with ``BENCH_SMOKE=1`` and its
artifact directory moved to a temporary one. Every count column must
equal the reference's: resident peaks, iterations, prefill tokens, hit
rate, waste and shared fractions, instances reached, free blocks,
preemptions, served counts and token identity. Timing columns are not
compared. The weights differ (each package draws its own from the seed),
which moves no count: every request runs to its ``max_new_tokens``.

Chunked preemption decides on the pool's clock and its calibrated
contention fit, so both sides run it under the same fake clock (``DT_S``
a pool step) with the fit pinned to ``FIT`` and the token-cost fit to
``TOKEN_COST``; its engine panel counts every step as built (the
reference's jit compiles otherwise drop steps from its count). The
reference's ``fig_multimodel_concurrency`` is not run (its slowest): the
port's is checked for the reference's rows and fields alone.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.figures import run as fig_run

ROOT = Path(__file__).resolve().parents[1]
ENGINE_FIGS = ("fig_paged_kv", "fig_preemption_chunked", "fig_prefix_cache")
#: the pinned calibration: contention (t1 ms, c) and token cost (base ms,
#: ms per token); a pool step's length on the fake clock
FIT = (5.0, 0.1)
TOKEN_COST = (2.0, 0.5)
DT_S = 0.02

#: the pinned clock and fits, and the engine step that reports no build;
#: ``pool_cls``/``engine_cls`` are each package's classes
PATCH = r"""
def pin(pool_cls, engine_cls):
    clock = [0.0]
    pool_step, engine_step = pool_cls.step, engine_cls.step

    def step(self, *a, **kw):
        clock[0] += DT_S
        return pool_step(self, *a, **kw)

    def eng_step(self, *a, **kw):
        out = engine_step(self, *a, **kw)
        self.last_step_compiled = False
        return out

    pool_cls.now = lambda self: clock[0]
    pool_cls.step = step
    pool_cls.contention = lambda self: FIT
    pool_cls.token_cost = lambda self: TOKEN_COST
    engine_cls.step = eng_step
"""

REF_SCRIPT = r"""
import contextlib, io, json, sys
out_dir, dump = sys.argv[1], sys.argv[2]
from repro.serving.engine import ContinuousBatchingEngine
from repro.serving.runtime import ModelInstancePool
res, buf = {}, io.StringIO()
with contextlib.redirect_stdout(buf):
    for name in FIGS:
        mod = __import__(f"benchmarks.{name}", fromlist=["main"])
        mod.OUT_DIR = out_dir
        if name == "fig_preemption_chunked":
            pin(ModelInstancePool, ContinuousBatchingEngine)
        res[name] = mod.main()
res["stdout"] = buf.getvalue()
json.dump(res, open(dump, "w"))
"""


def _consts() -> str:
    return (f"FIGS = {ENGINE_FIGS!r}\nFIT = {FIT!r}\n"
            f"TOKEN_COST = {TOKEN_COST!r}\nDT_S = {DT_S!r}\n")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_engine_figs")
    dump = tmp / "ref.json"
    env = dict(os.environ, BENCH_SMOKE="1", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", _consts() + PATCH + REF_SCRIPT, str(tmp),
         str(dump)], env=env, cwd=tmp, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(dump.read_text())
    res["rows"] = _rows(res.pop("stdout"))
    return res


@pytest.fixture(scope="module")
def ours(tmp_path_factory):
    """The port's payloads and rows, the four engine figures at the smoke
    profile on the CPU; chunked preemption under the pinned clock."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.runtime import ModelInstancePool

    tmp = tmp_path_factory.mktemp("port_engine_figs")
    ns = {}
    exec(_consts() + PATCH, ns)
    res, buf = {}, io.StringIO()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.setenv("BENCH_SMOKE", "1")
            mp.chdir(tmp)
            for name in ENGINE_FIGS + ("fig_multimodel_concurrency",):
                mod = __import__(f"repro_torch.figures.{name}",
                                 fromlist=["main"])
                if name != "fig_preemption_chunked":
                    res[name] = mod.main(device="cpu")
                    continue
                with pytest.MonkeyPatch.context() as pins:
                    # record the originals, for ``pin`` to overwrite
                    for cls, attrs in (
                            (ModelInstancePool,
                             ("now", "step", "contention", "token_cost")),
                            (ContinuousBatchingEngine, ("step",))):
                        for attr in attrs:
                            pins.setattr(cls, attr, getattr(cls, attr))
                    ns["pin"](ModelInstancePool, ContinuousBatchingEngine)
                    res[name] = mod.main(device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    res["rows"] = _rows(buf.getvalue())
    res["dir"] = tmp
    return res


def _rows(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        if line.startswith("#") or line.count(",") < 2:
            continue
        name, _, derived = line.split(",", 2)
        rows[name] = derived
    return rows


def _fields(derived: str) -> list:
    return [t.split("=", 1)[0] for t in derived.split() if "=" in t]


def _counts(row: dict, keys) -> dict:
    return {k: row[k] for k in keys}


def _prefix_rows(rows: dict, prefix: str) -> dict:
    return {k: v for k, v in rows.items() if k.startswith(prefix + ".")}


@pytest.mark.parametrize("prefix", ["fig_paged", "fig_preempt",
                                    "fig_prefix"])
def test_rows_and_fields_are_the_references(prefix, ref, ours):
    got, want = (_prefix_rows(r["rows"], prefix) for r in (ours, ref))
    assert want and list(got) == list(want)
    for name, derived in want.items():
        if name.endswith((".json", ".plot")):
            assert Path(got[name]).name == Path(derived).name
            assert (ours["dir"] / got[name]).is_file()
        else:
            assert _fields(got[name]) == _fields(derived), name


def test_paged_kv_counts_are_the_references(ref, ours):
    want, got = ref["fig_paged_kv"], ours["fig_paged_kv"]
    keys = ("layout", "budget_tokens", "peak_resident", "sequences_per_gb",
            "mean_kv_waste_frac", "n_iters")
    assert [_counts(r, keys) for r in got["capacity"]] \
        == [_counts(r, keys) for r in want["capacity"]]
    keys = ("layout", "m_c_requested", "m_c_reached", "peak_resident",
            "free_blocks", "tokens_per_seq")
    assert [_counts(r, keys) for r in got["pool"]] \
        == [_counts(r, keys) for r in want["pool"]]
    assert got["capacity_ratio"] == want["capacity_ratio"]
    assert got["pool_resident_ratio"] == want["pool_resident_ratio"]
    for name in ("fig_paged.capacity.dense", "fig_paged.capacity.paged",
                 "fig_paged.capacity.ratio", "fig_paged.pool.resident_ratio"):
        assert ours["rows"][name] == ref["rows"][name]


def test_prefix_cache_counts_are_the_references(ref, ours):
    want, got = ref["fig_prefix_cache"], ours["fig_prefix_cache"]
    keys = ("prefix_cache", "budget_blocks", "peak_resident",
            "prefill_tokens", "prefix_hit_rate", "peak_kv_shared_frac",
            "kv_waste_frac")
    assert [_counts(r, keys) for r in got["rows"]] \
        == [_counts(r, keys) for r in want["rows"]]
    for key in ("capacity_ratio", "prefill_reduction", "token_identical",
                "prefix_tokens", "n_requests"):
        assert got[key] == want[key], key
    for name in ("fig_prefix.baseline", "fig_prefix.cached",
                 "fig_prefix.capacity_ratio", "fig_prefix.prefill_reduction"):
        assert ours["rows"][name] == ref["rows"][name]


def test_preemption_counts_are_the_references(ref, ours):
    """Under the pinned clock and fits: the engine panel's step counts,
    and the pool panel's preemptions, attainment, hog lengths and
    token identity."""
    want, got = ref["fig_preemption_chunked"], ours["fig_preemption_chunked"]
    keys = ("token_budget", "prefill_steps", "n_steps")
    assert [_counts(r, keys) for r in got["engine"]] \
        == [_counts(r, keys) for r in want["engine"]]
    keys = ("preemption", "n_preempted", "urgent_slo_attainment",
            "hog_tokens_ok", "hog_token_identical")
    assert [_counts(r, keys) for r in got["pool"]] \
        == [_counts(r, keys) for r in want["pool"]]
    assert got["pool"][1]["n_preempted"] > 0
    assert got["hog_tokens"] == want["hog_tokens"]


def test_multimodel_concurrency_rows(ours):
    """The reference's rows and fields (from its source), finite numbers,
    every model served at every m_c, and the JSON artifact."""
    rows = _prefix_rows(ours["rows"], "fig_mm")
    models = ("tiny-dense", "tiny-wide")
    want = [f"fig_mm.mc{m_c}.{x}" for m_c in (1, 2, 3)
            for x in models + ("contention",)]
    want += ["fig_mm.best_mc", "fig_mm.json", "fig_mm.plot"]
    assert list(rows) == [n for n in want if n in rows] and \
        set(want) - set(rows) <= {"fig_mm.plot"}
    for m_c in (1, 2, 3):
        for m in models:
            assert _fields(rows[f"fig_mm.mc{m_c}.{m}"]) \
                == ["thr", "p50", "slo", "u"]
        assert _fields(rows[f"fig_mm.mc{m_c}.contention"]) == ["t1", "c"]
    assert set(json.loads(rows["fig_mm.best_mc"])) == set(models)
    payload = ours["fig_multimodel_concurrency"]
    assert (ours["dir"] / rows["fig_mm.json"]).is_file()
    for row in payload["rows"]:
        for m in models:
            pm = row["per_model"][m]
            assert pm["throughput_rps"] > 0.0
            assert all(map(_finite, pm.values()))
    assert not re.search(r"\b(nan|inf)\b", " ".join(rows.values()), re.I)


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


# ---------------------------------------------------------------- run.py
def _run_cli(*args, env=None, timeout=300):
    env = dict(os.environ if env is None else env,
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.figures.run",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_run_only_and_smoke(tmp_path):
    """``--only`` selects by substring, ``--smoke`` the toy profile: the
    banner lines, the rows, the artifact under the working directory."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.figures.run", "--smoke",
         "--only", "prefix", "--device", "cpu"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "# === fig_prefix_cache ==="
    assert re.fullmatch(r"# fig_prefix_cache took \d+\.\ds", lines[-1])
    assert sum(line.startswith("# ===") for line in lines) == 1
    assert "fig_prefix.baseline,0.00,resident=" in out.stdout
    # the smoke scale's 48-token prefix
    art = json.loads((tmp_path / "experiments" / "figures_torch"
                      / "fig_prefix_cache.json").read_text())
    assert art["prefix_tokens"] == 48


def test_run_exits_nonzero_when_a_module_fails(monkeypatch, capsys):
    """A module that raises prints its ERROR row and traceback, the
    others still run, and the runner exits non-zero."""
    ran = []

    def boom(device):
        raise RuntimeError("boom")

    for name, fn in (("fig_boom", boom),
                     ("fig_fine", lambda device: ran.append(device))):
        monkeypatch.setitem(sys.modules, f"repro_torch.figures.{name}",
                            types.SimpleNamespace(main=fn))
    monkeypatch.setattr(fig_run, "MODULES", ["fig_boom", "fig_fine"])
    with pytest.raises(SystemExit) as exc:
        fig_run.main(["--device", "cpu"])
    assert exc.value.code == "1 figure module(s) failed"
    out = capsys.readouterr()
    assert "fig_boom,0.00,ERROR" in out.out
    assert "RuntimeError: boom" in out.err
    assert ran == ["cpu"]


def test_run_refuses_cuda_without_a_gpu():
    """The default device is ``cuda``: without a GPU the runner raises
    the port's "no CUDA device" error before any module runs."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli("--smoke", "--only", "fig1", env=env, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "# ===" not in out.stdout


def test_run_lists_the_ported_figures_in_the_references_order():
    ref = (ROOT / "benchmarks" / "run.py").read_text()
    ref_modules = re.findall(r'^    "(\w+)",$', ref, re.M)
    assert len(ref_modules) == 19
    assert fig_run.MODULES == ref_modules
    for name in fig_run.MODULES:
        assert (ROOT / "src" / "repro_torch" / "figures"
                / f"{name}.py").is_file()
