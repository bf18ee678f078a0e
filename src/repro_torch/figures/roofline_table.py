"""The roofline tables on an H100: the per-(arch x shape x mesh) table from
the port's dry-run JSON artifacts in ``experiments/dryrun_torch/``, the
analytic roofline of the paged-attention kernels
(``paged_prefill_attention`` chunk prefill and
``paged_decode_attention_splitk``) at representative serving shapes, and
the analytic tensor-parallel trade-off per degree.

Every constant is an NVIDIA H100 SXM data-sheet figure
(``launch.roofline``): ``PEAK_FLOPS`` (dense bf16), ``FP32_PEAK_FLOPS``,
``HBM_BW``, ``LINK_BW`` (NVLink 4, one direction) and the card's 80 GB of
HBM as the fit budget. Nothing here is measured.

The kernel rows price the port's serving pool: fp32 KV (4 bytes an
element) at the fp32 peak, the bound PERF.md's kernel table uses. The TP
rows price bf16 serving, the dtype ``workload_cost`` counts, so their
all-reduce payload is bf16 too.

Run:  PYTHONPATH=src python -m repro_torch.figures.roofline_table
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.config.base import InputShape, ModelConfig
from repro_torch.figures.common import emit
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR
from repro_torch.launch.roofline import (FP32_PEAK_FLOPS, HBM_BW, LINK_BW,
                                         workload_cost)
from repro_torch.serving.bcedge import (TP_PAYLOAD_BYTES,
                                        tp_collective_ms_per_token)

#: the H100's HBM (data sheet), the budget a case must fit per device
H100_HBM_GB = 80.0


def load_results(dirname: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def render_table(rows, fit_budget_gb: float = H100_HBM_GB) -> str:
    lines = [
        "| arch | shape | mesh | GiB/dev | fits | compute ms | memory ms |"
        " collective ms | dominant | useful FLOP ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — |"
                f" — | — | skip: {r['reason'][:40]} | — |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR |"
                f" {r['error'][:40]} | | | | | |")
            continue
        gib = r["bytes_per_device"] / 2 ** 30
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {gib:.2f} |"
            f" {'Y' if gib <= fit_budget_gb else 'N'} |"
            f" {t['compute_s']*1e3:.2f} | {t['memory_s']*1e3:.2f} |"
            f" {t['collective_s']*1e3:.2f} |"
            f" {r['dominant'].split('_')[0]} |"
            f" {r['useful_flops_ratio']:.2f} |")
    return "\n".join(lines)


# =====================================================================
# paged-attention kernels (repro_torch/kernels): analytic roofline
# =====================================================================
#: (label, batch, q_heads, kv_heads, head_dim, context, chunk, n_splits)
#: a 7B-ish server shape and a small edge shape, long and short ctx
KERNEL_SHAPES = [
    ("edge-short", 1, 8, 8, 64, 512, 64, 4),
    ("edge-long", 4, 8, 8, 64, 2048, 64, 8),
    ("7b-decode", 8, 32, 8, 128, 2048, 128, 8),
    ("7b-batch", 16, 32, 8, 128, 1024, 128, 4),
]
KV_DTYPE_BYTES = 4  # the port's fp32 pool


def kernel_rows(shapes=KERNEL_SHAPES):
    """Analytic roofline per kernel per shape (one card).

    * decode (split-K): FLOPs = 4*B*H*ctx*hd (QK^T + PV, 2 flops/MAC),
      HBM = the K+V stream over the live context; the split axis divides
      the serial KV stream across ``n_splits`` SMs at the price of a
      partial-output combine (n_splits f32 partials per (b, h)).
    * prefill (chunk T over block tables): FLOPs = 4*B*H*T*ctx*hd, HBM =
      one K+V stream + the chunk's own KV write. The STAGING round trip
      this kernel replaces moved prefix KV three extra times (pool ->
      staging gather, staging attention re-read, staging -> pool graft),
      reported as ``staging_bytes`` for the traffic-saved column.
    """
    rows = []
    for label, b, h, kv, hd, ctx, chunk, n_splits in shapes:
        kv_stream = 2 * b * kv * ctx * hd * KV_DTYPE_BYTES
        # ---- split-K decode
        flops = 4.0 * b * h * ctx * hd
        combine = b * h * hd * n_splits * 4 * 2  # write + read partials
        serial_ms = max(flops / FP32_PEAK_FLOPS, kv_stream / HBM_BW) * 1e3
        splitk_ms = max(flops / FP32_PEAK_FLOPS,
                        (kv_stream / n_splits + combine) / HBM_BW) * 1e3
        rows.append({
            "kernel": "paged_decode_splitk", "shape": label,
            "ctx": ctx, "flops": flops, "hbm_bytes": kv_stream + combine,
            "intensity": flops / (kv_stream + combine),
            "serial_ms": serial_ms, "latency_ms": splitk_ms,
            "n_splits": n_splits, "bound": "memory"
            if kv_stream / HBM_BW > flops / FP32_PEAK_FLOPS else "compute"})
        # ---- fused chunk prefill
        pflops = 4.0 * b * h * chunk * ctx * hd
        chunk_write = 2 * b * kv * chunk * hd * KV_DTYPE_BYTES
        fused_bytes = kv_stream + chunk_write
        staging_bytes = fused_bytes + 3 * kv_stream  # the deleted trips
        pf_ms = max(pflops / FP32_PEAK_FLOPS, fused_bytes / HBM_BW) * 1e3
        rows.append({
            "kernel": "paged_prefill", "shape": label, "ctx": ctx,
            "flops": pflops, "hbm_bytes": fused_bytes,
            "intensity": pflops / fused_bytes, "serial_ms": pf_ms,
            "latency_ms": pf_ms, "n_splits": 1,
            "staging_bytes": staging_bytes, "bound": "memory"
            if fused_bytes / HBM_BW > pflops / FP32_PEAK_FLOPS
            else "compute"})
    return rows


def render_kernel_table(rows) -> str:
    lines = [
        "| kernel | shape | ctx | GFLOP | MiB | FLOP/B | bound |"
        " latency us | vs serial | staging traffic |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        speedup = r["serial_ms"] / max(r["latency_ms"], 1e-12)
        staging = f"{r['staging_bytes'] / 2**20:.1f} MiB" \
            if "staging_bytes" in r else "—"
        lines.append(
            f"| {r['kernel']} | {r['shape']} | {r['ctx']} |"
            f" {r['flops']/1e9:.2f} | {r['hbm_bytes']/2**20:.1f} |"
            f" {r['intensity']:.1f} | {r['bound']} |"
            f" {r['latency_ms']*1e3:.1f} |"
            f" {speedup:.2f}x (K={r['n_splits']}) | {staging} |")
    return "\n".join(lines)


# =====================================================================
# tensor-parallel collectives: analytic TP trade-off per degree
# =====================================================================
#: (label, ModelConfig, batch, context): the decode shapes the sharded
#: engine serves; a 7B-ish server model and a 1B-ish edge model
TP_SHAPES = [
    ("7b-decode",
     ModelConfig(name="tp-7b", family="dense", n_layers=32, d_model=4096,
                 n_heads=32, n_kv_heads=8, d_ff=11008, vocab_size=32_000),
     8, 2048),
    ("edge-1b",
     ModelConfig(name="tp-1b", family="dense", n_layers=16, d_model=2048,
                 n_heads=16, n_kv_heads=16, d_ff=5632, vocab_size=32_000),
     4, 1024),
]
TP_DEGREES = (1, 2, 4, 8)
#: bytes of an all-reduced element in the TP rows: bf16, as
#: ``workload_cost`` prices the rest of the row
TP_ROW_BYTES = 2


def tp_rows(shapes=TP_SHAPES, degrees=TP_DEGREES):
    """Analytic decode-step roofline per TP degree.

    compute/memory come from the shared ``workload_cost`` model divided
    over ``d`` cards (``WorkloadCost.terms``); collective bytes are the
    per-token all-reduce payload the guard prices
    (``serving.bcedge.tp_collective_ms_per_token``: 2 ring all-reduces
    of the (d_model,) residual per layer, ``2(d-1)/d`` of the payload per
    card, here at bf16) times the batch. Step latency = max(compute,
    memory) + collective; the speedup column shows where extra cards stop
    paying for the link.
    """
    rows = []
    for label, cfg, b, ctx in shapes:
        shape = InputShape(f"tp-{label}", ctx, b, "decode")
        cost = workload_cost(cfg, shape)
        base_ms = None
        for d in degrees:
            coll_per_chip = b * tp_collective_ms_per_token(cfg, d) \
                * LINK_BW / 1000.0 * TP_ROW_BYTES / TP_PAYLOAD_BYTES
            t = cost.terms(d, coll_per_chip)
            step_ms = (max(t["compute_s"], t["memory_s"])
                       + t["collective_s"]) * 1e3
            if base_ms is None:
                base_ms = step_ms
            rows.append({
                "shape": label, "tp": d, "batch": b, "ctx": ctx,
                "compute_ms": t["compute_s"] * 1e3,
                "memory_ms": t["memory_s"] * 1e3,
                "collective_ms": t["collective_s"] * 1e3,
                "step_ms": step_ms, "speedup": base_ms / step_ms,
                "coll_frac": (t["collective_s"] * 1e3) / step_ms,
                "bound": "collective"
                if t["collective_s"] > max(t["compute_s"], t["memory_s"])
                else ("memory" if t["memory_s"] > t["compute_s"]
                      else "compute")})
    return rows


def render_tp_table(rows) -> str:
    lines = [
        "| shape | tp | batch | ctx | compute ms | memory ms |"
        " collective ms | step ms | speedup | coll % | bound |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['shape']} | {r['tp']} | {r['batch']} | {r['ctx']} |"
            f" {r['compute_ms']:.3f} | {r['memory_ms']:.3f} |"
            f" {r['collective_ms']:.3f} | {r['step_ms']:.3f} |"
            f" {r['speedup']:.2f}x | {r['coll_frac']*100:.0f}% |"
            f" {r['bound']} |")
    return "\n".join(lines)


def main(device="cuda") -> dict:
    """The three tables; analytic, so ``device`` (the runner's) is
    unused."""
    krows = kernel_rows()
    mem_bound = sum(1 for r in krows if r["bound"] == "memory")
    emit("roofline.kernels", 0.0,
         f"cases={len(krows)} memory_bound={mem_bound}/{len(krows)}")
    print(render_kernel_table(krows))

    trows = tp_rows()
    best = {r["shape"]: r for r in trows if r["speedup"] == max(
        x["speedup"] for x in trows if x["shape"] == r["shape"])}
    emit("roofline.tp_collectives", 0.0,
         f"cases={len(trows)} best_degree=" + ",".join(
             f"{s}:tp{r['tp']}({r['speedup']:.2f}x)"
             for s, r in sorted(best.items())))
    print(render_tp_table(trows))

    rows = load_results(os.path.join(os.getcwd(), DRYRUN_DIR))
    if not rows:
        emit("roofline.table", 0.0, "no dry-run artifacts found; run "
             "PYTHONPATH=src python -m repro_torch.launch.dryrun --all "
             "first")
        return {"kernels": krows, "tp": trows}
    ok = [r for r in rows if r["status"] == "ok"]
    fit = sum(1 for r in ok
              if r["bytes_per_device"] / 2 ** 30 <= H100_HBM_GB)
    dominant = {}
    for r in ok:
        dominant[r["dominant"]] = dominant.get(r["dominant"], 0) + 1
    emit("roofline.summary", 0.0,
         f"cases={len(rows)} ok={len(ok)} "
         f"fits_80GiB={fit}/{len(ok)} dominant={dominant}")
    print(render_table(rows))
    return {"rows": rows, "kernels": krows, "tp": trows}


if __name__ == "__main__":
    main()
