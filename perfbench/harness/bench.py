"""One run of one cell: set-up, the window, the metrics, the check.

``run_cell`` makes the weights on the device from the seed, builds the
program's ``ContinuousBatchingEngine`` with the cell's settings, warms up
the shapes the cell's traffic uses (every power-of-two prefill piece up
to the token budget, and the decode step over all slots), then drives the
cell's schedule through ``serve.Driver`` and reads the metrics from the
run's records. After the window the engine's KV pool is freed, the peak
memory already read, and the plain reference checks a seeded sample of
the finished requests.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import check
from perfbench.harness.serve import Driver, Spans, Stamps, Window
from perfbench.harness.trace import DeviceTrace
from perfbench.harness.weights import make_params
from perfbench.traffic.generator import Schedule

#: the configuration file's keys that the program's ModelConfig takes
SHAPE_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope", "rope_theta", "activation",
              "norm", "tie_embeddings")
#: the program's largest prefill piece
MAX_PIECE = 512


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def import_program(root: Path):
    """The program from this checkout's ``src``; raises ImportError when
    the checkout has none."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if Path(src).resolve() not in where.parents:
        raise ImportError(f"repro_torch comes from {where}, not {src}")
    from repro_torch.config.registry import get_config
    from repro_torch.serving.engine import ContinuousBatchingEngine
    return get_config, ContinuousBatchingEngine


def model_config(get_config, conf: Dict):
    base = get_config(conf["registry"])
    cfg = dataclasses.replace(base, **{k: conf[k] for k in SHAPE_KEYS})
    if cfg.block_pattern != ("attn",) or cfg.n_experts or cfg.frontend \
            or cfg.enc_dec or cfg.qk_norm or cfg.sliding_window:
        raise ValueError(f"{conf['name']}: not a plain dense decoder")
    return cfg


def warm_up(engine, budget: int) -> None:
    """One forward of every shape the cell's steps take: the prefill
    pieces 1, 2, 4, .. up to min(budget, MAX_PIECE) and the decode step
    over every slot, written into the null block."""
    dev, nb, n = engine.device, engine.blocks_per_slot, engine.n_slots

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    T = 1
    while T <= min(budget, MAX_PIECE):
        engine.model.prefill_chunk(engine.params, engine.cache, {
            "tokens": zeros(1, T), "pos": zeros(1),
            "block_tables": zeros(1, nb)})
        T *= 2
    engine.model.decode_step(engine.params, engine.cache, {
        "tokens": zeros(n, 1), "pos": zeros(n), "block_tables": zeros(n, nb)})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Run:
    """What the metric readers read (``perfbench/metrics/<name>.py``)."""
    cell: cell_mod.Cell
    block_size: int
    setup_s: float
    window: Window
    stamps: Stamps
    spans: Optional[Spans]

    @property
    def cfg(self) -> Dict:
        return self.cell.config

    @property
    def trace(self) -> Optional[DeviceTrace]:
        t = self.window.trace
        return t if t is not None and t.kernels else None

    def ttfts_ms(self) -> List[float]:
        """Time to first token of every request due in the window, from
        when it was due; one with none counts until the run stopped."""
        st = self.stamps
        return [((st.tokens[r][0] if r in st.tokens else self.window.stopped)
                 - st.due[r]) * 1e3 for r in self.window.window_rids]

    def itl_gaps(self) -> List[float]:
        """Every inter-token gap whose later token landed in the window."""
        a, b = self.window.start, self.window.end
        out = []
        for ts in self.stamps.tokens.values():
            out += [t1 - t0 for t0, t1 in zip(ts, ts[1:]) if a <= t1 <= b]
        return out

    def tokens_in_window(self) -> int:
        a, b = self.window.start, self.window.end
        return sum(sum(1 for t in ts if a <= t <= b)
                   for ts in self.stamps.tokens.values())

    def traced_forwards(self) -> List[Dict]:
        t = self.window.trace
        if self.spans is None or t is None:
            return []
        return [f for f in self.spans.forwards if t.t0 <= f["t0"] <= t.t1]

    def loop_step_ms(self) -> Optional[float]:
        """Host ms a step from the window's first step boundary to where
        the loop stopped, traced or not (the run's log line)."""
        s = self.window.stats
        if "steps_from" not in s or "steps_to" not in s:
            return None
        (t0, n0), (t1, n1) = s["steps_from"], s["steps_to"]
        return 1e3 * (t1 - t0) / (n1 - n0) if n1 > n0 else None

    def counter_delta(self, key: str) -> Optional[float]:
        s = self.window.stats
        if "trace_start" not in s or "trace_end" not in s:
            return None
        return s["trace_end"][key] - s["trace_start"][key]

    def class_seconds(self, cls: str) -> float:
        return self.trace.seconds_matching(self.cell.kernel_patterns(cls))


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values), q)) if len(values) \
        else None


def rate_of(cell: cell_mod.Cell) -> float:
    """An open loop's rate: the mix's share of the cell's knee."""
    return float(cell.mix["rate"]["share_of_knee"]) \
        * float(cell.settings["knee_rps"])


def setup(root: Path, workload: str, seed: int, device):
    """The cell, the weights made from ``seed`` and the warmed-up
    engine."""
    t = [time.perf_counter()]
    cell = cell_mod.load(root, workload)
    get_config, Engine = import_program(root)
    mcfg = model_config(get_config, cell.config)
    eng_set = cell.settings["engine"]
    t.append(time.perf_counter())
    params = make_params(cell.config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    engine = Engine(mcfg, max_slots=eng_set["max_slots"],
                    max_seq=eng_set["max_seq"],
                    kv_layout=eng_set["kv_layout"],
                    block_size=eng_set["block_size"],
                    token_budget=eng_set["token_budget"], device=device,
                    params=params)
    t.append(time.perf_counter())
    warm_up(engine, eng_set["token_budget"])
    t.append(time.perf_counter())
    phases = dict(zip(("program_import_s", "weights_s", "engine_s",
                       "warm_up_s"), np.diff(t).tolist()))
    return cell, params, engine, phases


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: Optional[float] = None,
             controls: Sequence[str] = (), hook=None) -> Dict:
    """One run; returns the result line's object. ``controls`` adds the
    lower-precision readings to ``checks`` (the control runs). ``hook``,
    a callable given the engine after set-up, breaks the timed path for
    the tests that must see ``correct`` false, or returns a probe whose
    ``rows(rid)`` the check compares (the control runs)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell, params, engine, phases = setup(root, workload, seed, device)
    probe = hook(engine) if hook is not None else None
    setup_s = time.perf_counter() - t_start
    log(f"{workload} seed {seed}: setup {setup_s:.3f} s")

    if trace and device.type == "cuda":
        DeviceTrace.prime(device)
    stamps = Stamps()
    spans = Spans(engine, stamps) if trace else None
    factory = (lambda: DeviceTrace(device)) \
        if trace and device.type == "cuda" else None
    driver = Driver(engine, stamps, spans, factory)
    sched = Schedule(cell.mix, seed, cell.config["vocab_size"])
    loop = cell.mix["loop"]
    t_run = time.perf_counter()
    if loop == "open":
        win = driver.run_open(sched, rate_of(cell), seconds,
                              int(cell.settings.get("preadmit", 0)))
    elif loop == "closed":
        win = driver.run_closed(sched, engine.n_slots, seconds)
    else:
        raise cell_mod.CellError(f"unknown loop {loop!r}")
    t_done = time.perf_counter()
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    run = Run(cell, engine.block_size, setup_s, win, stamps, spans)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    if loop == "open":
        attempted = len(win.window_rids)
        failed = sum(1 for r in win.window_rids if r not in stamps.tokens)
    else:
        a, b = win.start, win.end
        attempted = sum(1 for ts in stamps.tokens.values()
                        if any(a <= t <= b for t in ts))
        failed = 0
    truncated = sum(1 for r in stamps.results.values() if r.truncated)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if run.trace is not None:
        t = run.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": t.top_ops(),
                     "idle_gaps": t.idle_by_host(spans.spans)}

    # the program's state goes before the reference runs
    chk = cell.settings["check"]
    picks = check.sample(stamps.results, seed, chk["tokens"],
                         chk["max_requests"])
    requests = {rid: (stamps.req[rid].prompt, stamps.results[rid].tokens,
                      probe.rows(rid) if probe is not None else None)
                for rid in picks}
    engine.cache = None
    del engine, driver, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = check.widest(cell.config, params, requests, device, controls)
    ref_s = time.perf_counter() - t_ref
    n_tok = sum(len(r[1]) for r in requests.values())
    served = gaps.get("served")  # None: no finished request to compare
    checks = {
        "logit_gap": {"value": served, "limit": chk["logit_gap"]},
        "tokens_compared_min": {"value": n_tok, "limit": chk["tokens"]},
        "truncated_max": {"value": truncated, "limit": 0}}
    for mode in controls:
        checks[f"control_{mode}_gap"] = {"value": gaps[mode],
                                         "limit": chk["logit_gap"]}
    for k in ("program_logit_err", "min_margin"):
        if k in gaps:
            checks[k] = {"value": gaps[k], "limit": chk["logit_gap"]}
    correct = (served is not None and served <= chk["logit_gap"]
               and n_tok >= chk["tokens"] and truncated == 0)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    log("run " + json.dumps({
        "seed": seed, "setup_s": setup_s, **phases,
        "before_window_s": win.start - t_run,
        "after_window_s": t_done - win.end,
        "reference_s": ref_s, "requests_checked": len(requests),
        "requests_finished": len(stamps.results),
        "ttft_ms_p50_p90": [percentile(run.ttfts_ms(), q) for q in (50, 90)]
        if loop == "open" else None,
        "itl_ms_p50_p95": [percentile([1e3 * g for g in run.itl_gaps()], q)
                           for q in (50, 95)],
        "tokens_in_window": run.tokens_in_window(),
        "loop_step_ms": run.loop_step_ms()}))
    result["checks"] = checks
    return result


def emit(result: Dict) -> None:
    """The compared numbers with their limits as the last lines of
    standard error, then the result as the last line of standard out."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
