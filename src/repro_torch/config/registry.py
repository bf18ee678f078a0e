"""Architecture registry: ``--arch <id>`` resolution.

Config modules in ``repro_torch.configs`` call :func:`register` at
import time. ``get_config(arch)`` imports the configs package lazily so
that importing ``repro_torch.config`` alone never drags in model code.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}
_REDUCERS: Dict[str, Callable[[ModelConfig], ModelConfig]] = {}


def register(cfg: ModelConfig, reducer: Optional[Callable] = None) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    if reducer is not None:
        _REDUCERS[cfg.name] = reducer
    return cfg


def _ensure_loaded() -> None:
    if not _REGISTRY:
        importlib.import_module("repro_torch.configs")


def get_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    if arch not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_REGISTRY)} "
            "(the other architectures are still to port, see ROADMAP.md)"
        )
    return _REGISTRY[arch]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def default_reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced smoke variant: 2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    head_dim = 64
    n_heads = max(2, d_model // head_dim)
    q_per_kv = cfg.q_per_kv
    n_kv = max(1, n_heads // min(q_per_kv, n_heads))
    n_heads = n_kv * min(q_per_kv, n_heads)
    changes = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        dense_ff=min(cfg.dense_ff, 512) if cfg.dense_ff else None,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
        rglru_width=min(cfg.rglru_width, d_model) if cfg.rglru_width else None,
        # no capacity drops at smoke scale => decode == full-forward exactly
        capacity_factor=8.0,
    )
    return dataclasses.replace(cfg, **changes)


def get_reduced_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    cfg = get_config(arch)
    reducer = _REDUCERS.get(arch, default_reduce)
    return reducer(cfg)
