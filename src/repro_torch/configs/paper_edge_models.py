"""The paper's own six served DNN models (Table IV) with their SLOs; a copy
of the reference's ``repro.configs.paper_edge_models`` (no JAX in it).

These are the tenants of the BCEdge serving experiments (Figs. 7-16). Each
profile carries the analytic compute/memory footprint that parameterises the
edge latency model (serving/latency_model.py).

FLOPs are per-image forward FLOPs at the paper's 224x224 input (TinyBERT:
per Speech-Commands utterance), taken from the source papers and scaled to
224 resolution where the reference resolution differs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class EdgeModelProfile:
    name: str
    short: str
    task: str
    input_shape: Tuple[int, ...]
    slo_ms: float          # Table IV
    gflops: float          # per-sample forward GFLOPs
    params_m: float        # millions of parameters
    activation_mb: float   # per-sample activation footprint (MB, fp16)


EDGE_MODELS: Dict[str, EdgeModelProfile] = {
    "yolo": EdgeModelProfile(
        "YOLO-v5s", "yolo", "detection", (3, 224, 224),
        slo_ms=138.0, gflops=2.03, params_m=7.2, activation_mb=24.0),
    "mob": EdgeModelProfile(
        "MobileNet-v3", "mob", "classification", (3, 224, 224),
        slo_ms=86.0, gflops=0.22, params_m=5.4, activation_mb=8.0),
    "res": EdgeModelProfile(
        "ResNet-18", "res", "classification", (3, 224, 224),
        slo_ms=58.0, gflops=1.82, params_m=11.7, activation_mb=12.0),
    "eff": EdgeModelProfile(
        "EfficientNet-B0", "eff", "classification", (3, 224, 224),
        slo_ms=93.0, gflops=0.39, params_m=5.3, activation_mb=16.0),
    "inc": EdgeModelProfile(
        "Inception-v3", "inc", "classification", (3, 224, 224),
        slo_ms=66.0, gflops=3.19, params_m=23.8, activation_mb=18.0),
    "bert": EdgeModelProfile(
        "TinyBERT", "bert", "speech", (1, 14),
        slo_ms=114.0, gflops=0.12, params_m=14.5, activation_mb=4.0),
}
