"""Beyond-paper figure: self-speculative decoding with batched parallel
verification.

Decode-heavy repetitive trace, the prompt-lookup regime: short periodic
prompts whose greedy continuations settle into repeating motifs
(templated/boilerplate generation). A screening pass generates a few
tokens per candidate with the k=0 engine and keeps the prompts whose
output tail is periodic, so the measured trace is honestly drawn from
the baseline's own behaviour, not hand-picked token ids. Two paged
engines on ``device`` share weights and drain the same trace:

1. **k=0 baseline**: one committed token per slot per iteration;
2. **speculative k=4**: the n-gram proposer drafts up to 4 tokens per
   slot from the sequence's own history; ONE verify forward over the
   paged cache (``paged_prefill_attention`` over each slot's window)
   scores all drafts; the longest matching prefix commits and rejected
   tail blocks roll back at block granularity.

Asserted (the acceptance bar):
  * >= 1.5x decode throughput (tokens/s over the drain), fast and full
    profiles,
  * greedy outputs token-identical per request across the two engines.

Artifacts: ``experiments/figures_torch/fig_speculative.json`` (always)
and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_speculative
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, check, emit, profile,
                                        pyplot, write_json)
from repro_torch.serving.engine import ContinuousBatchingEngine

TINY = ModelConfig(name="tiny-spec", family="dense", n_layers=2,
                   d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                   vocab_size=211)

BLOCK_SIZE = 16
SPEC_K = 4
PROMPT_TOKENS = 16         # short prompts: the trace is decode-heavy
MAX_SEQ = 256
MAX_SLOTS = 4
TAIL_PERIOD_MAX = 4        # "periodic" = tail repeats with period <= 4


class Scale(NamedTuple):
    """The trace's sizes: ``max_new`` tokens for each of ``n_requests``
    requests (long continuations amortize the screen), screened from
    ``n_candidates`` prompts by ``screen_tokens`` of generation."""
    max_new: int
    n_requests: int
    n_candidates: int
    screen_tokens: int


FULL = Scale(160, 8, 32, 48)
#: toy scale: the code paths, not the numbers
SMOKE = Scale(24, 4, 8, 24)


def _tail_period(tokens, tail: int = 24, max_p: int = TAIL_PERIOD_MAX):
    """Smallest period of the trailing ``tail`` tokens, or None."""
    t = list(tokens)[-tail:]
    for p in range(1, max_p + 1):
        if len(t) > p and all(t[i] == t[i + p] for i in range(len(t) - p)):
            return p
    return None


def _workload(base: ContinuousBatchingEngine, scale: Scale = FULL,
              seed: int = 1):
    """Screen periodic-motif candidate prompts with the BASELINE engine
    and keep those whose greedy continuation is itself periodic, then
    tile the survivors to ``n_requests`` streams (a templated workload
    re-issues the same prompts; each copy still occupies its own slot
    and pays its own decode). Raises ``AssertionError`` when no
    candidate's continuation is periodic."""
    rng = np.random.default_rng(seed)
    cands = []
    for _ in range(scale.n_candidates):
        motif = rng.integers(1, TINY.vocab_size, int(rng.integers(2, 5)))
        reps = int(np.ceil(PROMPT_TOKENS / len(motif)))
        cands.append(np.tile(motif, reps)[:PROMPT_TOKENS].astype(np.int32))
    screened = base.run(cands, max_new_tokens=scale.screen_tokens)
    periods = {r.request_id: _tail_period(r.tokens) for r in screened}
    sel = sorted((rid for rid, p in periods.items() if p is not None),
                 key=lambda rid: periods[rid])   # shortest period first
    check(bool(sel), "no candidate produced a periodic continuation")
    return [cands[sel[i % len(sel)]] for i in range(scale.n_requests)]


def _run(spec_k: int, prompts, share_from, scale: Scale = FULL,
         device="cuda"):
    eng = ContinuousBatchingEngine(
        TINY, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, seed=0,
        share_from=share_from, kv_layout="paged", block_size=BLOCK_SIZE,
        spec_k=spec_k, device=device)
    # warm the verify/decode shapes before the measured drain
    eng.run(prompts[:2], max_new_tokens=4)
    for p in prompts:
        eng.submit(p, max_new_tokens=scale.max_new)
    outputs = {}
    t0 = time.perf_counter()
    while (eng.waiting or eng.active_slots) and eng.n_iters < 50_000:
        for r in eng.step():
            outputs[r.request_id] = r.tokens
    dur_s = time.perf_counter() - t0
    check(len(outputs) == len(prompts),
          f"{len(outputs)}/{len(prompts)} drained")
    n_tokens = sum(len(t) for t in outputs.values())
    s = eng.stats()
    al = eng.allocator
    if al is not None:   # rollback must leave the pool conserved
        check(al.n_live == 0 and al.n_reserved == 0,
              "live or reserved blocks survived the drain")
        check(al.n_free + al.n_cached == al.n_blocks,
              "block conservation violated after the drain")
    return {
        "spec_k": spec_k,
        "tokens": n_tokens,
        "iters": int(s["n_iters"]),
        "accept_rate": s["spec_accept_rate"],
        "proposed": int(s["n_spec_proposed"]),
        "accepted": int(s["n_spec_accepted"]),
        "makespan_s": dur_s,
        "tokens_per_s": n_tokens / max(dur_s, 1e-6),
        "outputs": outputs,
    }


def _plot(rows: list, scale: Scale, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(11, 3.3))
    labels = [f"k={r['spec_k']}" for r in rows]
    axes[0].bar(labels, [r["tokens_per_s"] for r in rows],
                color=["#888", "#2a7"])
    axes[0].set_title("decode throughput (tokens/s)")
    axes[1].bar(labels, [r["iters"] for r in rows],
                color=["#888", "#2a7"])
    axes[1].set_title("engine iterations to drain")
    axes[2].bar(labels, [r["accept_rate"] for r in rows],
                color=["#888", "#2a7"])
    axes[2].set_title("draft acceptance rate")
    fig.suptitle(
        f"self-speculative decoding, k={SPEC_K}, "
        f"{scale.n_requests}x{scale.max_new}-token decode-heavy trace")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    smoke = profile().smoke
    scale = SMOKE if smoke else FULL
    base_eng = ContinuousBatchingEngine(
        TINY, max_slots=MAX_SLOTS, max_seq=MAX_SEQ, seed=0,
        kv_layout="paged", block_size=BLOCK_SIZE, device=device)
    try:
        prompts = _workload(base_eng, scale)
    except AssertionError:
        if not smoke:
            raise
        # the toy screen may find nothing; the code path is what smoke runs
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, TINY.vocab_size, PROMPT_TOKENS)
                   .astype(np.int32) for _ in range(scale.n_requests)]
    base = _run(0, prompts, base_eng, scale, device)
    spec = _run(SPEC_K, prompts, base_eng, scale, device)

    # token identity: per request id (submission order matches)
    for rid, toks in base.pop("outputs").items():
        check(np.array_equal(toks, spec["outputs"][rid]),
              f"request {rid}: speculative output diverges from baseline")
    spec.pop("outputs")

    speedup = spec["tokens_per_s"] / max(base["tokens_per_s"], 1e-9)
    for row in (base, spec):
        label = f"k{row['spec_k']}"
        emit(f"fig_spec.{label}", 0.0,
             f"tok/s={row['tokens_per_s']:.0f} iters={row['iters']} "
             f"accept={row['accept_rate']:.2f}")
    emit("fig_spec.speedup", 0.0, f"{speedup:.2f}x")
    if not smoke:
        # the acceptance bar
        check(speedup >= 1.5,
              f"speculative tokens/s gain {speedup:.2f}x < 1.5x")

    payload = {"spec_k": SPEC_K, "prompt_tokens": PROMPT_TOKENS,
               "max_new_tokens": scale.max_new, "block_size": BLOCK_SIZE,
               "n_requests": scale.n_requests, "rows": [base, spec],
               "speedup": speedup, "token_identical": True}
    emit("fig_spec.json", 0.0, write_json("fig_speculative", payload))
    png_path = os.path.join(OUT_DIR, "fig_speculative.png")
    if _plot([base, spec], scale, png_path):
        emit("fig_spec.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
