"""The port's paper figures (Figs. 1, 7-16, continuous vs round) against
the reference's ``benchmarks/`` at the smoke profile, on the CPU.

The reference runs once, in a subprocess with ``BENCH_SMOKE=1`` (its
profile is read at import) and its artifact directory moved to a
temporary one, so nothing is written under ``benchmarks/``. Its
``fig14_15_slo`` is not run (its slowest); the port's is checked alone,
its EDF column against the reference's ``train_agent``/``eval_agent``.
The port runs in this process under ``BENCH_SMOKE=1`` on
``device="cpu"``.

* ``FixedScheduler`` over the exact simulator (Fig. 1, continuous vs
  round): every ``derived`` field equals the reference's exactly.
* The numpy schedulers' columns (EDF, GA) are exact too.
* ``eval_agent`` with the reference's SAC nets bridged in, greedy, guard
  off, gives the reference's summary exactly.
* ``make_agent`` gives each kind the reference's hyperparameters.
* Fig. 13: the linear predictor's numbers within 1e-6 relative; the NN,
  started from the reference's weights, within ``NN_RTOL`` relative
  (full-batch Adam in another framework drifts by rounding).
* The learned-agent figures: the reference's row names and fields, with
  finite values.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config.base import ServingConfig
from repro_torch.core.interference import (LinearInterferencePredictor,
                                           NNInterferencePredictor)
from repro_torch.figures import common, fig13_interference
from repro_torch.models.bridge import interference_from_jax, sac_nets_from_jax

ROOT = Path(__file__).resolve().parents[1]

#: the paper figures both packages run here, in the reference's order
FIGS = ("fig1_motivation", "fig7_utility", "fig8_9_timeline",
        "fig10_convergence", "fig11_12_scalability", "fig13_interference",
        "fig16_overhead", "fig_continuous_vs_round")
KINDS = ("sac", "tac", "ppo", "ddqn", "ga", "edf", "fixed")
#: Fig. 15's request rates at the fast and smoke profiles
FIG15_RATES = (10, 30, 40)
#: the port's Fig. 14/15 rows, with their fields: the reference's source
#: (``benchmarks/fig14_15_slo.py``) at the fast and smoke profiles
FIG14_15_ROWS = {
    "fig14.with_predictor": ["violation_rate"],
    "fig14.without": ["violation_rate"],
    "fig14.summary": ["with", "without", "improved"],
    **{f"fig15.{k}": [f"rps{r}" for r in FIG15_RATES]
       for k in ("sac", "tac", "edf")},
    "fig15.summary": ["bcedge_avg", "tac_avg", "deeprt_avg",
                      "bcedge_lowest"],
}
#: relative gap the NN predictor's error percentiles may have when both
#: sides start from the reference's weights: full-batch Adam at lr 3e-3
#: amplifies rounding near convergence (the two predictors' validation
#: predictions differ by 2e-5 relative after one epoch, 2.1e-3 after the
#: smoke profile's 300)
NN_RTOL = 5e-3
#: the reference's evaluation length here: the smoke profile's episodes
EVAL_MS = 2_000.0

REF_SCRIPT = r"""
import contextlib, dataclasses, io, json, sys
import numpy as np
out_dir, dump = sys.argv[1], sys.argv[2]
import benchmarks.fig_continuous_vs_round as cont
cont.OUT_DIR = out_dir
from benchmarks import common
from repro.config.base import ServingConfig
from repro.core.interference import NNInterferencePredictor
mods = {name: __import__(f"benchmarks.{name}", fromlist=["main"])
        for name in FIGS}
buf = io.StringIO()
res = {}
with contextlib.redirect_stdout(buf):
    for name, mod in mods.items():
        print(f"# === {name} ===")
        ret = mod.main(fast=True)
        if name == "fig13_interference":
            res["fig13"] = ret
        if name == "fig_continuous_vs_round":
            res["fig_cont"] = ret["rows"]
    edf = []
    for rps in RATES:
        cfg = ServingConfig(arrival_rps=float(rps))
        agent, pred, _ = common.train_agent("edf", cfg, episodes=10,
                                            guard=False)
        _, r = common.eval_agent(agent, cfg, pred, guard=False)
        edf.append(r.summary.get("slo_violation_rate", 1.0))
    print("fig15.edf,0.00," + " ".join(
        f"rps{r}={v:.3f}" for r, v in zip(RATES, edf)))
res["stdout"] = buf.getvalue()
def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t).tolist()
cfg = ServingConfig()
agents = {}
for kind in KINDS:
    a = common.make_agent(kind, cfg)
    d = {}
    for k, v in vars(a).items():
        if k == "cfg":
            d[k] = v._asdict()
        elif k == "hw":
            d[k] = dataclasses.asdict(v)
        elif k == "replay":
            d[k] = v.capacity
        elif k == "state":
            d[k] = {n: [list(np.shape(l["w"])) for l in net["layers"]]
                    for n, net in v._asdict().items()
                    if isinstance(net, dict) and "layers" in net}
        elif isinstance(v, (bool, int, float, str, list, tuple)):
            d[k] = list(v) if isinstance(v, tuple) else v
        elif isinstance(v, np.ndarray):
            d[k] = v.tolist()
    agents[kind] = d
res["agents"] = agents
sac = common.make_agent("sac", cfg)
_, r = common.eval_agent(sac, cfg, None, guard=False, episode_ms=EVAL_MS)
res["sac_eval"] = {"summary": r.summary,
                   "per_model_utility": r.per_model_utility,
                   "per_model_throughput": r.per_model_throughput,
                   "per_model_latency": r.per_model_latency}
nets = {n: getattr(sac.state, n) for n in
        ("policy", "q1", "q2", "q1_target", "q2_target", "log_alpha")}
res["sac_nets"] = np_tree(nets)
res["nn_init"] = np_tree(NNInterferencePredictor(lr=3e-3).state.net)
json.dump(res, open(dump, "w"))
"""


def _ref_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["BENCH_SMOKE"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's rows and return values, its agents'
    hyperparameters, a bridged SAC evaluation and the Fig. 13 NN's
    initial weights, from one subprocess."""
    tmp = tmp_path_factory.mktemp("ref_figs")
    dump = tmp / "ref.json"
    script = (f"FIGS = {FIGS!r}\nRATES = {FIG15_RATES!r}\n"
              f"KINDS = {KINDS!r}\nEVAL_MS = {EVAL_MS!r}\n" + REF_SCRIPT)
    out = subprocess.run([sys.executable, "-c", script, str(tmp), str(dump)],
                         env=_ref_env(), cwd=tmp, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(dump.read_text())
    res["rows"] = _rows(res.pop("stdout"))
    return res


@pytest.fixture(scope="module")
def ours(tmp_path_factory):
    """The port's rows and return values: every ported paper figure at
    the smoke profile on the CPU, in the reference's order."""
    tmp = tmp_path_factory.mktemp("port_figs")
    buf = io.StringIO()
    ret = {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("BENCH_SMOKE", "1")
            mp.chdir(tmp)
            with contextlib.redirect_stdout(buf):
                for name in FIGS + ("fig14_15_slo",):
                    mod = __import__(f"repro_torch.figures.{name}",
                                     fromlist=["main"])
                    ret[name] = mod.main(device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    return {"rows": _rows(buf.getvalue()), "returns": ret, "dir": tmp}


def _rows(text: str) -> dict:
    """``name -> derived`` for every CSV row of ``text``."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("#") or line.count(",") < 2:
            continue
        name, _, derived = line.split(",", 2)
        rows[name] = derived
    return rows


def _fields(derived: str) -> list:
    return [t.split("=", 1)[0] for t in derived.split() if "=" in t]


def _token(derived: str, key: str) -> str:
    return next(t for t in derived.split() if t.startswith(key + "="))


def _prefixed(rows: dict, prefix: str) -> dict:
    return {k: v for k, v in rows.items() if k.split(".")[0] == prefix}


ROW_PREFIX = {"fig1_motivation": ("fig1",), "fig7_utility": ("fig7",),
              "fig8_9_timeline": ("fig8", "fig9", "fig8_9"),
              "fig10_convergence": ("fig10",),
              "fig11_12_scalability": ("fig11_12",),
              "fig13_interference": ("fig13",),
              "fig16_overhead": ("fig16",),
              "fig_continuous_vs_round": ("fig_cont",)}


@pytest.mark.parametrize("fig", FIGS)
def test_rows_and_fields_are_the_references(fig, ref, ours):
    """Every figure prints the reference's row names, each with the
    reference's fields, and every number in them is finite."""
    for prefix in ROW_PREFIX[fig]:
        got, want = (_prefixed(r["rows"], prefix) for r in (ours, ref))
        assert want, prefix
        assert list(got) == list(want)
        for name in want:
            assert _fields(got[name]) == _fields(want[name]), name
            _assert_finite(got[name])


def test_fig14_15_rows_and_fields(ours):
    got = {**_prefixed(ours["rows"], "fig14"),
           **_prefixed(ours["rows"], "fig15")}
    assert list(got) == list(FIG14_15_ROWS)
    for name, fields in FIG14_15_ROWS.items():
        assert _fields(got[name]) == fields, name
        _assert_finite(got[name])


def _assert_finite(derived: str) -> None:
    assert not re.search(r"\b(nan|inf)\b", derived, re.I), derived
    nums = re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", derived)
    assert all(math.isfinite(float(x)) for x in nums), derived


@pytest.mark.parametrize("prefix", ["fig1", "fig_cont"])
def test_fixed_scheduler_figures_are_exact(prefix, ref, ours):
    """``FixedScheduler`` over the exact simulator: every derived field
    equals the reference's (the artifact rows name a file: same
    basename)."""
    got, want = (_prefixed(r["rows"], prefix) for r in (ours, ref))
    for name, derived in want.items():
        if name in ("fig_cont.json", "fig_cont.plot"):
            assert Path(got[name]).name == Path(derived).name
            assert (ours["dir"] / got[name]).is_file()
        else:
            assert got[name] == derived, name
    if prefix == "fig_cont":
        assert ours["returns"]["fig_continuous_vs_round"]["rows"] \
            == ref["fig_cont"]


def test_numpy_scheduler_columns_are_exact(ref, ours):
    """EDF (DeepRT) and GA are numpy in both packages: their columns
    are the reference's to the printed digit."""
    got, want = ours["rows"], ref["rows"]
    for m in common.MODELS:
        assert _token(got[f"fig7.{m}"], "edf") \
            == _token(want[f"fig7.{m}"], "edf")
    assert _token(got["fig7.summary"], "deeprt") \
        == _token(want["fig7.summary"], "deeprt")
    assert got["fig10.curve.ga"] == want["fig10.curve.ga"]
    for platform in ("jetson_nano", "jetson_tx2", "xavier_nx"):
        name = f"fig11_12.{platform}.edf"
        assert got[name] == want[name]
    assert got["fig15.edf"] == want["fig15.edf"]


def test_fig13_linear_and_bridged_nn(ref, ours):
    """The linear predictor (closed form) within 1e-6 relative of the
    reference's; the NN started from the reference's weights within
    ``NN_RTOL`` relative, on the same dataset."""
    want = ref["fig13"]
    got = ours["returns"]["fig13_interference"]
    np.testing.assert_allclose(got["linear"], want["linear"], rtol=1e-6)
    X, y, tr, va = fig13_interference.dataset(smoke=True)
    nn = NNInterferencePredictor(lr=3e-3, device="cpu")
    nn.load_net(interference_from_jax(_arrays(ref["nn_init"])))
    torch.set_num_threads(1)
    errs = fig13_interference.errors(nn, X, y, tr, va, epochs=300)
    np.testing.assert_allclose(errs, want["nn"], rtol=NN_RTOL)
    lin = fig13_interference.errors(LinearInterferencePredictor(), X, y,
                                    tr, va, epochs=300)
    np.testing.assert_allclose(lin, want["linear"], rtol=1e-6)


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_arrays(v) for v in tree]
    return np.asarray(tree, np.float32)


def test_eval_agent_with_bridged_sac_is_exact(ref):
    """The reference's SAC nets in the port's agent: greedy, guard off,
    ``eval_agent`` gives the reference's summary and per-model maps."""
    cfg = ServingConfig()
    sac = common.make_agent("sac", cfg, device="cpu")
    sac.load_nets(sac_nets_from_jax(_arrays(ref["sac_nets"])))
    _, res = common.eval_agent(sac, cfg, None, guard=False,
                               episode_ms=EVAL_MS)
    want = ref["sac_eval"]
    assert res.summary == want["summary"]
    assert res.per_model_utility == want["per_model_utility"]
    assert res.per_model_throughput == want["per_model_throughput"]
    assert res.per_model_latency == want["per_model_latency"]


@pytest.mark.parametrize("kind", KINDS)
def test_make_agent_hyperparameters(kind, ref):
    """Every scalar, array and config the reference's agent holds, its
    replay capacity and its nets' layer shapes, on the port's."""
    want = ref["agents"][kind]
    agent = common.make_agent(kind, ServingConfig(), device="cpu")
    for key, w in want.items():
        v = getattr(agent, key) if key != "state" else None
        if key == "cfg":
            assert v._asdict() == w
        elif key == "hw":
            assert vars(v) == w
        elif key == "replay":
            assert v.capacity == w
        elif key == "state":
            for net, shapes in w.items():
                mlp = getattr(agent, net)
                assert [list(p.shape) for p in mlp.w] == shapes, net
        elif isinstance(v, np.ndarray):
            assert v.tolist() == w, key
        else:
            assert (list(v) if isinstance(v, tuple) else v) == w, key
    if kind in ("sac", "tac", "ppo", "ddqn"):
        assert agent.device == torch.device("cpu")
