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
* **Frontends and encoders.** ``frontend_proj`` (d, d) crosses as it is.
  An encoder-decoder model's ``encoder["layers"]`` is one dict stacked
  over ``n_enc_layers`` (``transformer.py:95-99``) and leaves as a list
  in order; its decoder layers' ``cross_norm`` and ``cross`` ride in each
  layer's dict, as do the cross K/V ``ck``/``cv`` in a cache.

The scheduler agents' nets (:func:`sac_nets_from_jax`; the baselines'
:func:`tac_nets_from_jax`, :func:`ppo_nets_from_jax` and
:func:`ddqn_nets_from_jax`) and the interference predictor's
(:func:`interference_from_jax`) are ``{"layers": [{"w": (in, out), "b":
(out,)}, ...]}`` on both sides, also untransposed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.baselines import DDQNAgent, PPOAgent, TACAgent
from repro_torch.core.sac import NETS


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
    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    p = {"embed": tensor(params_np["embed"]),
         "final_norm": _map(params_np["final_norm"], tensor),
         "layers": [_map(layer, tensor)
                    for layer in unstack_layers(params_np, cfg)]}
    if not cfg.tie_embeddings:
        p["lm_head"] = tensor(params_np["lm_head"])
    if "frontend_proj" in params_np:
        p["frontend_proj"] = tensor(params_np["frontend_proj"])
    if "encoder" in params_np:
        enc = params_np["encoder"]
        p["encoder"] = {
            "layers": [_map(enc["layers"], lambda a, i=i: tensor(a[i]))
                       for i in range(cfg.n_enc_layers)],
            "final_norm": _map(enc["final_norm"], tensor)}
    return p


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def mlp_from_jax(net_np: Dict) -> Dict:
    """The state dict of a ``repro_torch.core.networks.MLP`` (CPU tensors)
    from one reference net ``{"layers": [{"w", "b"}, ...]}`` with numpy
    leaves."""
    sd = {}
    for i, layer in enumerate(net_np["layers"]):
        sd[f"w.{i}"] = _f32(layer["w"])
        sd[f"b.{i}"] = _f32(layer["b"])
    return sd


def sac_nets_from_jax(nets_np: Dict) -> Dict:
    """``SACAgent.load_nets`` input from the reference agent's nets with
    numpy leaves: ``{"policy", "q1", "q2", "q1_target", "q2_target"}``
    each ``{"layers": [{"w", "b"}, ...]}``, and the scalar
    ``"log_alpha"``. Each net becomes an MLP state dict."""
    out: Dict = {name: mlp_from_jax(nets_np[name]) for name in NETS}
    out["log_alpha"] = _f32(nets_np["log_alpha"])
    return out


def _nets_from_jax(state_np: Dict, names: Sequence[str]) -> Dict:
    return {name: mlp_from_jax(state_np[name]) for name in names}


def tac_nets_from_jax(state_np: Dict) -> Dict:
    """``TACAgent.load_nets`` input from the reference TAC agent's state
    (``state._asdict()`` with numpy leaves; its ``policy`` and ``value``
    nets are read)."""
    return _nets_from_jax(state_np, TACAgent.NETS)


def ppo_nets_from_jax(state_np: Dict) -> Dict:
    """``PPOAgent.load_nets`` input from the reference PPO agent's state
    (``state._asdict()`` with numpy leaves; its ``policy`` and ``value``
    nets are read)."""
    return _nets_from_jax(state_np, PPOAgent.NETS)


def ddqn_nets_from_jax(state_np: Dict) -> Dict:
    """``DDQNAgent.load_nets`` input from the reference DDQN agent's state
    (``state._asdict()`` with numpy leaves; its ``q`` and ``q_target``
    nets are read)."""
    return _nets_from_jax(state_np, DDQNAgent.NETS)


def interference_from_jax(net_np: Dict) -> Dict:
    """``NNInterferencePredictor.load_net`` input from the reference
    predictor's net (``state.net``) with numpy leaves."""
    return mlp_from_jax(net_np)
