"""The port's scripts on the CPU: the HTTP server smoke
(``python -m repro_torch.launch.server_smoke``) and the three examples
under ``examples_torch/`` (quickstart, serve_llm, the dry-run demo), each
run through its ``main`` at a small size. The examples' long runs (20 s
simulator episodes, 20 s of serving) are cut here by wrapping what they
call; their code paths are the ones the card runs without the cut.
"""
from __future__ import annotations

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **kw)


def test_server_smoke_passes_on_the_cpu(tmp_path):
    """The three checks (stream, disconnect -> cancel, 429 with a positive
    Retry-After) pass and the script exits 0."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.server_smoke", "--device",
         "cpu"], env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for check in ("PASS stream: 6 tokens", "PASS cancel: disconnects=1",
                  "PASS backpressure: "):
        assert any(line.startswith(check) for line in lines), check
    assert lines[-1] == "server smoke OK"


@pytest.mark.parametrize("argv", [
    ["-m", "repro_torch.launch.server_smoke"],
    [str(EXAMPLES / "quickstart.py")],
    [str(EXAMPLES / "serve_llm.py")],
])
def test_scripts_refuse_cuda_without_a_gpu(argv, tmp_path):
    """``--device`` defaults to ``cuda``: without a GPU each script raises
    the port's "no CUDA device" error."""
    out = subprocess.run([sys.executable, *argv],
                         env=_env(CUDA_VISIBLE_DEVICES=""), cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_quickstart_trains_and_compares_on_the_cpu(one_thread, monkeypatch,
                                                   capsys):
    """Six training episodes, then BCEdge against EDF and Fixed, with
    1 s episodes in place of 20 s ones."""
    mod = _example("quickstart")
    env_cls = mod.EdgeServingEnv
    monkeypatch.setattr(mod, "EdgeServingEnv", lambda cfg, episode_ms, seed=0:
                        env_cls(cfg, episode_ms=min(episode_ms, 1_000.0),
                                seed=seed))
    mod.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("  ep") for line in lines) == 6
    for name in ("BCEdge", "DeepRT(EDF)", "Fixed(b=2,mc=2)"):
        assert any(line.startswith(f"  {name} ") and "utility=" in line
                   for line in lines), name
    assert lines[-1].startswith("BCEdge utility gain vs DeepRT: ")


@pytest.mark.parametrize("exec_mode", ["round", "continuous"])
def test_serve_llm_serves_on_the_cpu(exec_mode, one_thread, monkeypatch,
                                     capsys):
    """The wrapper reaches ``engine_serve.main`` in each mode and serves
    requests, for 2 s in place of 20."""
    mod = _example("serve_llm")
    monkeypatch.setattr(mod.engine_serve, "main", functools.partial(
        mod.engine_serve.main, duration_s=2.0))
    mod.main(exec_mode, device="cpu")
    out = capsys.readouterr().out
    assert "on cpu..." in out
    assert f"[{exec_mode}] " in out


def test_multipod_dryrun_demo_prices_one_case(capsys):
    """qwen3-0.6b at decode_32k on the 16 x 16 mesh, run on ``meta``: the
    roofline terms the dry-run reports for the case."""
    from repro_torch.launch.dryrun import run_case

    mod = _example("multipod_dryrun_demo")
    mod.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    want = run_case("qwen3-0.6b", "decode_32k", False, verbose=False)
    assert "arch=qwen3-0.6b shape=decode_32k mesh=16x16" in out
    assert (f"bytes/device      : {want['bytes_per_device']/2**30:.2f} GiB"
            in out)
    assert f"dominant term     : {want['dominant']}" in out
