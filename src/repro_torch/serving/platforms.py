"""Hardware models for the serving simulator: the paper's three edge
platforms (Tables III/V), copied from the reference's
``repro.serving.platforms``.

The reference also carries a ``tpu_v5e`` entry whose constants were
written for a TPU serving cell; the port states no number taken on or for
a TPU, so it keeps the paper's platforms only (ROADMAP.md).

``eff_max``/``eff_half`` shape the batching-efficiency curve
eff(b) = eff_max * b / (b + eff_half): small batches underutilise the
accelerator, which is exactly the effect adaptive batching exploits.
``contention`` scales the latency inflation per additional concurrent
instance; ``mem_knee`` is the memory-pressure fraction beyond which
interference turns super-linear (paper Fig. 1's collapse region).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One edge platform's calibrated constants (paper Tables III/V;
    calibration method in docs/ARCHITECTURE.md §2)."""
    name: str
    tops: float            # effective accelerator throughput (G-ops/ms = TOPS)
    mem_gb: float
    cpu_cores: int
    eff_max: float
    eff_half: float
    contention: float      # per-extra-instance slowdown coefficient
    mem_knee: float        # fraction of memory where contention knees
    overhead_ms: float     # per-batch fixed launch overhead
    io_ms_per_mb: float    # request transmission cost (network model)


#: ``tops`` is the *effective achievable* Gops/ms on these small CNN/BERT
#: workloads (TensorRT-measured effective throughput is a small fraction of
#: the marketing peak in Table V; ratios follow the table, absolute values
#: calibrated so b=1 latencies match published TRT measurements, e.g.
#: YOLOv5s ≈ 29 ms on Xavier NX).
PLATFORMS: Dict[str, HardwareSpec] = {
    # Table V: 0.47 TFLOPS fp16, 4 GB, 128 CUDA cores
    "jetson_nano": HardwareSpec(
        "Jetson Nano", tops=0.11, mem_gb=4.0, cpu_cores=4,
        eff_max=0.50, eff_half=1.8, contention=0.10, mem_knee=0.70,
        overhead_ms=3.0, io_ms_per_mb=0.35),
    # Table V: 1.33 TFLOPS fp16, 8 GB, 256 CUDA cores
    "jetson_tx2": HardwareSpec(
        "Jetson TX2", tops=0.24, mem_gb=8.0, cpu_cores=6,
        eff_max=0.50, eff_half=1.6, contention=0.08, mem_knee=0.75,
        overhead_ms=2.0, io_ms_per_mb=0.30),
    # Table III: 21 TOPS INT8 (TensorRT path), 8 GB, 384 cores
    "xavier_nx": HardwareSpec(
        "Xavier NX", tops=0.50, mem_gb=8.0, cpu_cores=6,
        eff_max=0.50, eff_half=1.5, contention=0.06, mem_knee=0.78,
        overhead_ms=1.2, io_ms_per_mb=0.25),
}
