"""The port's second half of the figure runners (speculative decoding,
fused prefill, the sharded engine, KV offload, the roofline tables, async
serving) against the reference's ``benchmarks/`` at the smoke profile on
the CPU, and the engine's ``prefill_mode`` against the reference's.

The reference runs once, in a subprocess with ``BENCH_SMOKE=1`` and its
artifact directory moved to a temporary one; it also saves the weights
its speculative and fused engines drew (numpy leaves, pickled), and the
port's engines of those two figures take them, bridged, so the columns
that depend on the weights must be equal: the screened prompts, the
iterations, the acceptance and every token stream. ``fig_kv_offload``
decides on the pool's clock, so both sides run it under the pinned clock
and fits of ``tests/test_torch_figures_engine.py``; its preemption, swap
and leak counts and token identity must be equal. ``fig_sharded_engine``'s
block counts at tp 1 and 2 must be equal (the reference's pools on two
forced host devices, the port's on a mesh that names the CPU twice).
The roofline tables are priced on the H100's figures: their FLOPs equal
the reference's, the KV bytes are twice (fp32 against bf16) and the TP
rows' collective bytes equal. ``fig_async_serving``'s wall-clock gates
are not run here (they follow the host's speed); its episodes run on a
shortened trace and must hold the storm and leak gates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import KIND_CFGS
from repro.serving.engine import \
    ContinuousBatchingEngine as RefEngine
from repro_torch.config.base import ModelConfig
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool
from test_torch_figures_engine import (DT_S, FIT, PATCH, TOKEN_COST,
                                       _fields, _prefix_rows, _rows)

ROOT = Path(__file__).resolve().parents[1]
#: the reference's modules in the order they run: the pinned clock goes
#: on before fig_kv_offload and stays, so the figures that time their
#: steps run first
FIGS = ("fig_speculative", "fig_fused_kernels", "fig_sharded_engine",
        "fig_kv_offload", "roofline_table")
#: the figures whose engines take the reference's weights
BRIDGED = ("fig_speculative", "fig_fused_kernels")

#: records the token streams (and the speculative figure's prompts) each
#: side's figure produced, by wrapping the module's own functions
RECORD = r"""
def record(mod, name, rec, setattr=setattr):
    out = rec.setdefault(name, [])
    if name == "fig_speculative":
        run = mod._run

        def _run(spec_k, prompts, *a, **kw):
            res = run(spec_k, prompts, *a, **kw)
            out.append({"spec_k": spec_k,
                        "prompts": [[int(t) for t in p] for p in prompts],
                        "outputs": {str(k): [int(t) for t in v]
                                    for k, v in res["outputs"].items()}})
            return res
        setattr(mod, "_run", _run)
    elif name == "fig_fused_kernels":
        drain = mod._timed_drain

        def _timed_drain(eng, prompts, *a, **kw):
            res = drain(eng, prompts, *a, **kw)
            out.append({str(k): [int(t) for t in v]
                        for k, v in res[1].items()})
            return res
        setattr(mod, "_timed_drain", _timed_drain)
"""

REF_SCRIPT = r"""
import contextlib, io, json, pickle, sys
out_dir, dump, weights = sys.argv[1], sys.argv[2], sys.argv[3]
import jax
import numpy as np
from repro.serving.engine import ContinuousBatchingEngine
from repro.serving.runtime import ModelInstancePool
res, rec, buf = {}, {}, io.StringIO()
with contextlib.redirect_stdout(buf):
    for name in FIGS:
        mod = __import__(f"benchmarks.{name}", fromlist=["main"])
        mod.OUT_DIR = out_dir
        record(mod, name, rec)
        if name == "fig_kv_offload":
            pin(ModelInstancePool, ContinuousBatchingEngine)
        res[name] = mod.main()
res["stdout"] = buf.getvalue()
res["record"] = rec
json.dump(res, open(dump, "w"), default=float)
params = {}
for name in BRIDGED:
    tiny = sys.modules[f"benchmarks.{name}"].TINY
    params[name] = jax.tree.map(
        np.asarray, ContinuousBatchingEngine(tiny, seed=0).params)
pickle.dump(params, open(weights, "wb"))
"""


def _consts() -> str:
    return (f"FIGS = {FIGS!r}\nBRIDGED = {BRIDGED!r}\nFIT = {FIT!r}\n"
            f"TOKEN_COST = {TOKEN_COST!r}\nDT_S = {DT_S!r}\n")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_serving_figs")
    dump, weights = tmp / "ref.json", tmp / "weights.pkl"
    env = dict(os.environ, BENCH_SMOKE="1", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", _consts() + PATCH + RECORD + REF_SCRIPT,
         str(tmp), str(dump), str(weights)], env=env, cwd=tmp,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(dump.read_text())
    res["rows"] = _rows(res.pop("stdout"))
    with open(weights, "rb") as f:  # written by the subprocess above
        res["weights"] = pickle.load(f)
    return res


def _bridged(params_np):
    """The port's engine class, its engines that share no weights built
    on the reference's ``params_np`` (the figure's TINY)."""
    class Bridged(ContinuousBatchingEngine):
        def __init__(self, cfg, *a, **kw):
            if kw.get("share_from") is None:
                kw["params"] = params_from_jax(params_np, cfg)
            super().__init__(cfg, *a, **kw)
    return Bridged


@pytest.fixture(scope="module")
def ours(ref, tmp_path_factory):
    """The port's payloads, rows and streams, the five figures at the
    smoke profile on the CPU: speculative and fused on the reference's
    weights, KV offload under the pinned clock."""
    tmp = tmp_path_factory.mktemp("port_serving_figs")
    ns = {}
    exec(_consts() + PATCH + RECORD, ns)
    res, rec, buf = {}, {}, io.StringIO()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.setenv("BENCH_SMOKE", "1")
            mp.chdir(tmp)
            for name in FIGS:
                mod = __import__(f"repro_torch.figures.{name}",
                                 fromlist=["main"])
                ns["record"](mod, name, rec, mp.setattr)
                if name in BRIDGED:
                    mp.setattr(mod, "ContinuousBatchingEngine",
                               _bridged(ref["weights"][name]))
                if name == "fig_kv_offload":
                    # record the originals, for ``pin`` to overwrite
                    for cls, attrs in (
                            (ModelInstancePool,
                             ("now", "step", "contention", "token_cost")),
                            (ContinuousBatchingEngine, ("step",))):
                        for attr in attrs:
                            mp.setattr(cls, attr, getattr(cls, attr))
                    ns["pin"](ModelInstancePool, ContinuousBatchingEngine)
                res[name] = mod.main(device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    res["rows"] = _rows(buf.getvalue())
    res["record"] = rec
    res["dir"] = tmp
    return res


@pytest.mark.parametrize("prefix", ["fig_spec", "fig_fused", "fig_sharded",
                                    "fig_kv_offload", "roofline"])
def test_rows_and_fields_are_the_references(prefix, ref, ours):
    got, want = (_prefix_rows(r["rows"], prefix) for r in (ours, ref))
    assert want and list(got) == list(want)
    for name, derived in want.items():
        if name.endswith((".json", ".plot")):
            assert Path(got[name]).name == Path(derived).name
            assert (ours["dir"] / got[name]).is_file()
        else:
            assert _fields(got[name]) == _fields(derived), name


def test_speculative_streams_are_the_references(ref, ours):
    """On the same weights: the screened prompts, both engines' streams
    request by request, and the iterations and draft counts."""
    assert ours["record"]["fig_speculative"] \
        == ref["record"]["fig_speculative"]
    want, got = ref["fig_speculative"], ours["fig_speculative"]
    keys = ("spec_k", "tokens", "iters", "accept_rate", "proposed",
            "accepted")
    assert [{k: r[k] for k in keys} for r in got["rows"]] \
        == [{k: r[k] for k in keys} for r in want["rows"]]
    assert got["rows"][1]["accepted"] > 0
    for key in ("n_requests", "max_new_tokens", "token_identical"):
        assert got[key] == want[key], key


def test_fused_streams_are_the_references(ref, ours):
    """On the same weights: every timed drain's streams, staging and
    fused, and the identity variants checked."""
    streams = ours["record"]["fig_fused_kernels"]
    assert streams and streams == ref["record"]["fig_fused_kernels"]
    want, got = ref["fig_fused_kernels"], ours["fig_fused_kernels"]
    assert got["token_identity_variants"] == want["token_identity_variants"]
    assert [r["mode"] for r in got["rows"]] == ["staging", "fused"]
    for key in ("prefix_tokens", "tail_lens", "max_new", "repeats"):
        assert got[key] == want[key], key


def test_sharded_counts_are_the_references(ref, ours):
    want = ref["fig_sharded_engine"]["measured"]
    got = ours["fig_sharded_engine"]["measured"]
    keys = ("tp", "kv_charge_blocks", "kv_pool_blocks", "resident_capacity")
    for tp in ("tp1", "tp2"):
        assert {k: got[tp][k] for k in keys} \
            == {k: want[tp][k] for k in keys}, tp
    assert got["tp2"]["kv_pool_blocks"] == 2 * got["tp1"]["kv_pool_blocks"]
    assert [r["tp"] for r in ours["fig_sharded_engine"]["analytic"]] \
        == [r["tp"] for r in ref["fig_sharded_engine"]["analytic"]]


def test_kv_offload_counts_are_the_references(ref, ours):
    """Under the pinned clock and fits: each trial's preemptions, swaps,
    SLO outcomes, token identity and the two tiers' leak counts."""
    keys = ("mode", "seed", "n_preempted", "n_swap_preempted", "hog_met",
            "urgent_met", "hog_token_identical", "device_live",
            "host_live", "device_conserved", "host_conserved")
    want, got = ref["fig_kv_offload"], ours["fig_kv_offload"]
    assert [[{k: t[k] for k in keys} for t in r["trials"]]
            for r in got["rows"]] \
        == [[{k: t[k] for k in keys} for t in r["trials"]]
            for r in want["rows"]]
    for r in got["rows"]:
        assert r["token_identical"]
    assert got["rows"][1]["n_swap_preempted"] > 0
    assert got["hog_tokens"] == want["hog_tokens"]


def test_roofline_prices_the_references_work_on_an_h100(ref, ours):
    from repro_torch.launch import roofline as port_roofline
    from repro.launch import roofline as ref_roofline

    want, got = ref["roofline_table"], ours["roofline_table"]
    assert len(got["kernels"]) == len(want["kernels"]) == 8
    for g, w in zip(got["kernels"], want["kernels"]):
        assert (g["kernel"], g["shape"], g["ctx"], g["flops"]) \
            == (w["kernel"], w["shape"], w["ctx"], w["flops"])
        if g["kernel"] == "paged_prefill":
            assert g["hbm_bytes"] == 2 * w["hbm_bytes"]
            assert g["staging_bytes"] == 2 * w["staging_bytes"]
        else:  # the f32 partials' combine is the same bytes on both
            assert g["hbm_bytes"] - _combine(g) \
                == 2 * (w["hbm_bytes"] - _combine(w))
    assert len(got["tp"]) == len(want["tp"]) == 8
    for g, w in zip(got["tp"], want["tp"]):
        assert (g["shape"], g["tp"], g["batch"], g["ctx"]) \
            == (w["shape"], w["tp"], w["batch"], w["ctx"])
        # the same bytes priced at NVLink 4 and the TPU's link
        assert g["collective_ms"] * port_roofline.LINK_BW == pytest.approx(
            w["collective_ms"] * ref_roofline.ICI_BW, rel=1e-12)
        assert g["compute_ms"] * port_roofline.PEAK_FLOPS == pytest.approx(
            w["compute_ms"] * ref_roofline.PEAK_FLOPS, rel=1e-12)
    assert "rows" not in got  # no dry-run artifacts in the working dir


def _combine(row) -> float:
    """The split-K combine's bytes of a decode row (f32 partials, written
    and read), from its shape in ``KERNEL_SHAPES``."""
    from repro_torch.figures.roofline_table import KERNEL_SHAPES

    (b, h, hd, n_splits), = [(s[1], s[2], s[4], s[7]) for s in KERNEL_SHAPES
                             if s[0] == row["shape"]]
    return b * h * hd * n_splits * 4 * 2


def test_roofline_reads_the_ports_dry_run(tmp_path, monkeypatch, capsys):
    """The dry-run table comes from ``experiments/dryrun_torch``, never the
    reference's ``experiments/dryrun``, and fits are counted against the
    H100's 80 GB."""
    from repro_torch.figures import roofline_table

    row = {"arch": "qwen3-0.6b", "shape": "decode_32k", "mesh": "16x16",
           "status": "ok", "bytes_per_device": 81 * 2 ** 30,
           "roofline": {"compute_s": 1e-3, "memory_s": 2e-3,
                        "collective_s": 0.0},
           "dominant": "memory_s", "useful_flops_ratio": 0.5}
    for sub, arch in (("dryrun_torch", "qwen3-0.6b"), ("dryrun", "other")):
        (tmp_path / "experiments" / sub).mkdir(parents=True)
        (tmp_path / "experiments" / sub / "case.json").write_text(
            json.dumps(dict(row, arch=arch)))
    monkeypatch.chdir(tmp_path)
    out = roofline_table.main(device="cpu")
    assert [r["arch"] for r in out["rows"]] == ["qwen3-0.6b"]
    text = capsys.readouterr().out
    assert "roofline.summary,0.00,cases=1 ok=1 fits_80GiB=0/1" in text
    assert "| qwen3-0.6b | decode_32k | 16x16 | 81.00 | N |" in text


def test_async_serving_storm_and_leak_gates(monkeypatch):
    """Both policies' episodes on a 3 s flash crowd: every storm client is
    cancelled or throttled, at least one a slot is cancelled mid-stream,
    and no block, reservation or queue entry survives."""
    from repro_torch.figures import fig_async_serving as fa
    from repro_torch.serving.workload import ArrivalTrace

    monkeypatch.setattr(fa, "_trace", lambda short: ArrivalTrace.flash_crowd(
        3.0, base_rps=8.0, flash_rps=150.0, flash_start_frac=0.1,
        flash_frac=0.2))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = [fa._episode(bp, True, 7, "cpu") for bp in (True, False)]
    finally:
        torch.set_num_threads(n_threads)
    for row in rows:
        assert row["leak_n_live"] == row["leak_n_reserved"] == 0, row
        assert row["leak_n_queued"] == row["leak_n_resident"] == 0, row
        assert row["storm_other"] == 0, row
        assert row["storm_cancelled"] >= fa.MAX_SLOTS, row
        assert row["n"] == row["n_requests"] > 0
        for key in ("ttft_ms_p99", "attainment_tight", "n_finished",
                    "n_throttled", "n_abandoned"):
            assert key in row, key
    assert rows[0]["policy"] == "backpressure" and rows[0]["n_throttled"] > 0
    assert rows[1]["policy"] == "accept_all" and rows[1]["n_throttled"] == 0
    assert rows[1]["server_throttled"] == 0


# ----------------------------------------------------------- prefill_mode
PREFILL_CASES = [(kind, layout, mode) for kind in sorted(KIND_CFGS)
                 for layout in ("dense", "paged")
                 for mode in ("auto", "fused", "staging")]


def _outcome(make):
    try:
        eng = make()
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", eng.fused_prefill)


@pytest.mark.parametrize("kind,layout,mode", PREFILL_CASES)
def test_prefill_mode_accepts_and_refuses_as_the_reference(kind, layout,
                                                            mode):
    """``prefill_mode``: "fused" builds exactly where the reference's does
    (paged, every layer in the pool) and raises its ``ValueError``
    elsewhere; "auto" takes the same path; an unknown mode raises."""
    cfg = KIND_CFGS[kind]
    kw = dict(max_slots=2, max_seq=64, kv_layout=layout, prefill_mode=mode)
    want = _outcome(lambda: RefEngine(cfg, **kw))
    got = _outcome(lambda: ContinuousBatchingEngine(
        ModelConfig(**dataclasses.asdict(cfg)), device="cpu", **kw))
    assert got == want
    fused = layout == "paged" and kind in ("global", "tail")
    if mode == "staging":
        assert want == ("ValueError", "unknown prefill_mode 'staging'")
    elif mode == "fused" and not fused:
        assert want[0] == "ValueError"
    else:
        assert want == ("ok", fused)
