"""Minimal optax-like optimizer library on tensors: the port of
``repro.train.optimizer``.

An optimizer is a pair of functions ``(init, update)``::

    state = init(params)
    updates, state = update(grads, state, params)
    params = apply_updates(params, updates)

Implemented: SGD(+momentum), Adam, AdamW, global-norm clipping, and
warmup-cosine / constant schedules, in the reference's arithmetic order,
so updates match it step for step. Moments are float32 whatever the
params' dtype. Unlike the reference, whose arrays are immutable, the
port updates in place where that saves a copy of every parameter:
``update`` writes the moments into the state's tensors (the returned
state holds the same tensors, its step advanced), ``chain_clip``
scales the grads it is given and ``apply_updates`` adds into the params. Everything runs under ``torch.no_grad()``; a
schedule is evaluated on the host from the state's step, a CPU scalar,
so no update synchronises with the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.tree import (global_norm, tree_leaves, tree_map,
                                     tree_map_with_path)

#: step -> learning rate (a host float)
Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """params + updates, cast to each param's dtype, written into the
    params in place (they may be autograd leaves); returns ``params``."""
    def add(p, u):
        p.add_(u.to(p.dtype))
        return p

    return tree_map(add, params, updates)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------- schedules
def constant(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; float32 arithmetic, as the
    reference's."""
    f32 = np.float32

    def sched(step) -> float:
        s = f32(int(step))
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(floor) + f32(1 - floor) * f32(0.5) * (
            f32(1) + np.cos(f32(math.pi) * frac)))
        return float(cos)

    return sched


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant(lr)


# ---------------------------------------------------------------- SGD
class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(_step0(), mom)

    @torch.no_grad()
    def update(grads, state, params=None):
        lr_t = sched(int(state.step))
        if momentum:
            def mom_step(m, g):
                return m.mul_(momentum).add_(g)

            mom = tree_map(mom_step, state.momentum, grads)
            updates = tree_map(lambda m: m * -lr_t, mom)
        else:
            mom = None
            updates = tree_map(lambda g: g * -lr_t, grads)
        return updates, SGDState(state.step + 1, mom)

    return Optimizer(init, update)


# ---------------------------------------------------------------- Adam(W)
class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0,
         mask: Optional[Callable[[str], bool]] = None) -> Optimizer:
    """Adam; with ``weight_decay`` > 0 this is AdamW (decoupled decay).

    ``mask(path)`` (if given) returns False for leaves that should not be
    decayed (biases / norm scales).
    """
    sched = _as_schedule(lr)
    f32 = np.float32

    def init(params):
        def zeros():
            return tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)

        return AdamState(_step0(), zeros(), zeros())

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = sched(int(state.step))
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        g32 = [g.float() for g in tree_leaves(grads)]
        # mu = b1 * m + (1 - b1) * g; nu = b2 * v + (1 - b2) * g^2, with
        # no temporary the size of the params
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g32, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g32, g32, value=1 - b2)
        del g32
        bc1 = float(1 - f32(b1) ** f32(int(step)))
        bc2 = float(1 - f32(b2) ** f32(int(step)))
        lr_wd = float(f32(lr_t) * f32(weight_decay))

        def upd(m, v, p):
            u = torch.div(m, bc1).mul_(-lr_t).div_(
                torch.div(v, bc2).sqrt_().add_(eps))
            if weight_decay and p is not None:
                u.sub_(p.float() * lr_wd)
            return u

        if weight_decay and params is not None:
            if mask is not None:
                decay = tree_map_with_path(lambda k, p: mask(k), params)
                updates = tree_map(
                    lambda m, v, p, d: upd(m, v, p if d else None),
                    state.mu, state.nu, params, decay)
            else:
                updates = tree_map(upd, state.mu, state.nu, params)
        else:
            updates = tree_map(lambda m, v: upd(m, v, None), state.mu,
                               state.nu)
        return updates, AdamState(step, state.mu, state.nu)

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------- clipping
def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Global-norm gradient clipping composed in front of ``opt``. The
    scale stays on the device, and the grads are scaled in place: the
    update consumes its ``grads`` (a trainer's are used once), so no
    second copy of them is held."""

    @torch.no_grad()
    def update(grads, state, params=None):
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        torch._foreach_mul_(tree_leaves(grads), scale)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)
