"""State featurisation for the scheduler agents (paper state s_t parts
I-V: model type, input type/shape, SLO, available resources, queue info);
a copy of the reference's ``repro.serving.features`` (numpy only)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.serving.platforms import HardwareSpec

EXTRA_FEATURES = 8


def state_dim(models: Sequence[str]) -> int:
    return len(models) + EXTRA_FEATURES


def queue_feature_index(models: Sequence[str]) -> int:
    """Index of the queue-length feature (used by the EDF baseline)."""
    return len(models) + 4


def featurize(model: str, models: Sequence[str], hw: HardwareSpec,
              queue_len: int, oldest_age_ms: float, mem_used_gb: float,
              active_instances: int, accel_util: float) -> np.ndarray:
    prof = EDGE_MODELS[model]
    onehot = np.zeros(len(models), np.float32)
    onehot[list(models).index(model)] = 1.0
    extras = np.array([
        prof.slo_ms / 100.0,                    # (III) SLO
        np.log1p(prof.gflops),                  # (II) input/compute shape
        prof.params_m / 25.0,
        (hw.mem_gb - mem_used_gb) / hw.mem_gb,  # (IV) available memory
        np.log1p(float(queue_len)),             # (V) queue info [EDF: expm1]
        np.log1p(oldest_age_ms / max(prof.slo_ms, 1.0)),
        active_instances / 8.0,
        accel_util,
    ], np.float32)
    return np.concatenate([onehot, extras])
