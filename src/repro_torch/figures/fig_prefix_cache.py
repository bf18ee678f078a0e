"""Beyond-paper figure: prefix caching with copy-on-write block sharing.

Templated edge workload: every prompt is a 512-token shared prefix (a
system prompt / task preamble) plus a short per-request tail: the
regime where duplicated prefix KV is the dominant memory waste. Two
paged engines under the SAME tight block budget drain the same burst on
``device``:

1. **no-cache baseline**: every request re-prefills and physically
   stores the full prompt, so the budget caps concurrent residency at
   ``budget / request_blocks``;
2. **prefix cache**: full immutable prompt blocks are shared at
   refcount+1 (copy-on-write tails, LRU revival of evicted blocks), so
   after the first request each admission charges only its private
   tail + decode blocks.

Asserted (the acceptance bar):
  * >= 2x peak admission capacity (concurrently resident sequences),
  * >= 2x prefill-token reduction (chunked-prefill work actually run),
  * greedy outputs token-identical per request across the two engines.

Artifacts: ``experiments/figures_torch/fig_prefix_cache.json`` (always)
and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_prefix_cache
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

TINY = ModelConfig(name="tiny-prefix", family="dense", n_layers=2,
                   d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                   vocab_size=211)

BLOCK_SIZE = 16
MAX_NEW = 16
MAX_SLOTS = 8


class Scale(NamedTuple):
    """The workload's sizes: a ``prefix_tokens`` shared prefix and a
    ``tail_tokens`` unique tail (fixed length: left-padding makes sharing
    length-sensitive) per request, the engine's ``max_seq`` and block
    budget, and the burst."""
    prefix_tokens: int
    tail_tokens: int
    max_seq: int
    budget_blocks: int
    n_requests: int


#: the acceptance point: 512-token shared prefixes, a budget of ~2.3
#: no-cache requests' worth of blocks
FULL = Scale(512, 16, 704, 96, 12)
#: toy scale: the code paths, not the numbers
SMOKE = Scale(48, 8, 128, 24, 4)


def _workload(scale: Scale = FULL, seed: int = 0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, TINY.vocab_size, scale.prefix_tokens).astype(
        np.int32)
    return [np.concatenate(
        [prefix, rng.integers(1, TINY.vocab_size, scale.tail_tokens).astype(
            np.int32)]) for _ in range(scale.n_requests)]


def _run(prefix_cache: bool, prompts, scale: Scale = FULL, share_from=None,
         device="cuda"):
    eng = ContinuousBatchingEngine(
        TINY, max_slots=MAX_SLOTS, max_seq=scale.max_seq, seed=0,
        share_from=share_from, kv_layout="paged", block_size=BLOCK_SIZE,
        kv_blocks=scale.budget_blocks, prefix_cache=prefix_cache,
        device=device)
    # seed request: with the cache on it publishes the prefix blocks;
    # the baseline pays the same warmup, so the comparison stays fair
    eng.run([prompts[0]], max_new_tokens=MAX_NEW)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    chunk0 = eng.n_prefill_chunk_tokens
    peak_resident = 0
    peak_shared = 0.0
    outputs = {}
    t0 = time.perf_counter()
    while (eng.waiting or eng.active_slots) and eng.n_iters < 20_000:
        for r in eng.step():
            outputs[r.request_id] = r.tokens
        peak_resident = max(peak_resident, len(eng.active_slots))
        peak_shared = max(peak_shared, eng.stats()["kv_shared_frac"])
    dur_s = time.perf_counter() - t0
    check(len(outputs) == len(prompts),
          f"{len(outputs)}/{len(prompts)} drained")
    s = eng.stats()
    return eng, {
        "prefix_cache": prefix_cache,
        "budget_blocks": scale.budget_blocks,
        "peak_resident": peak_resident,
        "prefill_tokens": int(eng.n_prefill_chunk_tokens - chunk0),
        "prefix_hit_rate": s["prefix_hit_rate"],
        "peak_kv_shared_frac": peak_shared,
        "kv_waste_frac": s["kv_waste_frac"],
        "makespan_s": dur_s,
        "throughput_rps": len(prompts) / max(dur_s, 1e-6),
        "outputs": outputs,
    }


def _plot(rows: list, scale: Scale, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axes = plt.subplots(1, 3, figsize=(11, 3.3))
    labels = ["no cache", "prefix cache"]
    axes[0].bar(labels, [r["peak_resident"] for r in rows],
                color=["#888", "#2a7"])
    axes[0].set_title("peak resident sequences\n(same block budget)")
    axes[1].bar(labels, [r["prefill_tokens"] for r in rows],
                color=["#888", "#2a7"])
    axes[1].set_title("prefill tokens actually run")
    axes[2].bar(labels, [r["peak_kv_shared_frac"] for r in rows],
                color=["#888", "#2a7"])
    axes[2].set_title("peak shared-block fraction")
    fig.suptitle(
        f"{scale.prefix_tokens}-token shared prefixes, "
        f"{scale.budget_blocks * BLOCK_SIZE}-token KV budget")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    smoke = profile().smoke
    scale = SMOKE if smoke else FULL
    prompts = _workload(scale)
    base_eng, base = _run(False, prompts, scale, device=device)
    _, cached = _run(True, prompts, scale, share_from=base_eng,
                     device=device)

    # token identity: per request id (submission order matches)
    for rid, toks in base.pop("outputs").items():
        check(np.array_equal(toks, cached["outputs"][rid]),
              f"request {rid}: cached output diverges from baseline")
    cached.pop("outputs")

    cap_ratio = cached["peak_resident"] / max(1, base["peak_resident"])
    prefill_ratio = base["prefill_tokens"] \
        / max(1, cached["prefill_tokens"])
    for row in (base, cached):
        label = "cached" if row["prefix_cache"] else "baseline"
        emit(f"fig_prefix.{label}", 0.0,
             f"resident={row['peak_resident']} "
             f"prefill_tokens={row['prefill_tokens']} "
             f"hit={row['prefix_hit_rate']:.2f} "
             f"shared={row['peak_kv_shared_frac']:.2f}")
    emit("fig_prefix.capacity_ratio", 0.0, f"{cap_ratio:.2f}x")
    emit("fig_prefix.prefill_reduction", 0.0, f"{prefill_ratio:.2f}x")
    if not smoke:
        # the acceptance bar
        check(cap_ratio >= 2.0,
              f"admission capacity gain {cap_ratio:.2f}x < 2x")
        check(prefill_ratio >= 2.0,
              f"prefill-token reduction {prefill_ratio:.2f}x < 2x")

    payload = {"prefix_tokens": scale.prefix_tokens,
               "tail_tokens": scale.tail_tokens,
               "block_size": BLOCK_SIZE, "max_new_tokens": MAX_NEW,
               "budget_blocks": scale.budget_blocks,
               "n_requests": scale.n_requests,
               "rows": [base, cached], "capacity_ratio": cap_ratio,
               "prefill_reduction": prefill_ratio,
               "token_identical": True}
    emit("fig_prefix.json", 0.0, write_json("fig_prefix_cache", payload))
    png_path = os.path.join(OUT_DIR, "fig_prefix_cache.png")
    if _plot([base, cached], scale, png_path):
        emit("fig_prefix.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
