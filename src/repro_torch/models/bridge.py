"""Carry the reference's weights (and caches) into the port's layout.

The reference's param pytree, with its leaves converted to numpy
(``jax.tree.map(np.asarray, params)``), maps to the port's dict as
follows:

* **Scan-stacked units.** ``"units"`` is a tuple with one entry per
  ``block_pattern`` position; each leaf carries a leading ``n_units``
  axis, and an unrolled ``"tail"`` tuple follows
  (``transformer.py:68-100``). Layer order is: for each unit, for each
  pattern position; then the tail. :func:`unstack_layers` undoes this,
  for params and for decode caches alike, and carries every kind's
  nested dicts leaf for leaf (attention, RG-LRU ``rec``, RWKV
  ``time_mix``/``channel_mix``; recurrent states in caches). It splits
  off the unit axis only: an MoE layer's ``ffn`` (``router (d, E)``,
  ``w_gate``/``w_up (E, d, f)``, ``w_down (E, f, d)``, arctic's
  ``dense_mlp``) arrives with 4-D expert leaves ``(n_units, E, d, f)``
  and leaves as ``(E, d, f)``.
* **Weight orientation.** Dense weights are stored ``(d_in, d_out)`` and
  applied as ``x @ W`` on both sides, so nothing is transposed.
* **Tied head.** The tied LM head is the ``(V, d)`` embedding table
  itself (``transformer.py:418-421``); an untied ``lm_head`` is (d, V).

The SAC scheduler's nets (:func:`sac_nets_from_jax`) are ``{"layers":
[{"w": (in, out), "b": (out,)}, ...]}`` on both sides, also untransposed.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.sac import NETS
from repro_torch.models.transformer import check_supported


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def unstack_layers(tree: Dict, cfg: ModelConfig) -> List[Any]:
    """The reference's ``{"units": (...), "tail": (...)}`` pytree (params
    or decode cache) as one subtree per layer, in execution order."""
    k = len(cfg.block_pattern)
    n_units = cfg.n_layers // k
    layers = []
    units = tree.get("units", ())
    for u in range(n_units):
        for pos in range(k):
            layers.append(_map(units[pos], lambda a, u=u: a[u]))
    layers.extend(tree.get("tail", ()))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: found {len(layers)} layers, config "
                         f"has {cfg.n_layers}")
    return layers


def params_from_jax(params_np: Dict, cfg: ModelConfig,
                    device="cpu") -> Dict:
    """The port's params (float tensors on ``device``) from the reference's
    param pytree with numpy leaves."""
    check_supported(cfg)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    p = {"embed": tensor(params_np["embed"]),
         "final_norm": _map(params_np["final_norm"], tensor),
         "layers": [_map(layer, tensor)
                    for layer in unstack_layers(params_np, cfg)]}
    if not cfg.tie_embeddings:
        p["lm_head"] = tensor(params_np["lm_head"])
    return p


def sac_nets_from_jax(nets_np: Dict) -> Dict:
    """``SACAgent.load_nets`` input from the reference agent's nets with
    numpy leaves: ``{"policy", "q1", "q2", "q1_target", "q2_target"}``
    each ``{"layers": [{"w", "b"}, ...]}``, and the scalar
    ``"log_alpha"``. Each net becomes the state dict of a
    ``repro_torch.core.networks.MLP`` (CPU tensors)."""
    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    out: Dict = {}
    for name in NETS:
        sd = {}
        for i, layer in enumerate(nets_np[name]["layers"]):
            sd[f"w.{i}"] = tensor(layer["w"])
            sd[f"b.{i}"] = tensor(layer["b"])
        out[name] = sd
    out["log_alpha"] = tensor(nets_np["log_alpha"])
    return out
