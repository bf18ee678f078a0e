"""The rank-split forward: tensor-parallel serving of an attention-only
decoder over a ``("model",)`` mesh (``repro_torch.launch.mesh``).

The reference serves a tensor-parallel instance with ``jit`` under
``NamedSharding`` in/out specs (``serving/engine.py:999-1024``) and lets
GSPMD partition the step. The port runs the partition itself, from one
process: each rank holds the shard of every weight that
``engine_param_shardings`` gives it and the head shard of the KV cache
(``engine_cache_pspec``), each on its rank's device, and every step runs
the ranks in lockstep. A rank's shard config is ``cfg`` with ``n_heads``,
``n_kv_heads`` (and ``d_ff`` where the MLP splits) divided by the
degree, so the attention kernels launch once per rank per layer at the
rank's head counts.

Per layer, exactly two all-reduces (``models.shard_hooks``): one after
the row-split ``wo`` and one after the row-split ``w_down``, each rank's
partial of the sub-block added into the replicated residual. Per-head
qk-norm, RoPE, windows and rings stay within a rank. A vocabulary-split
embedding looks up the rows in the rank's range (zeros elsewhere) and
all-reduces them; a vocabulary-split head all-gathers its logits before
sampling. A leaf ``_fit_mesh`` leaves replicated (TINY's 97-entry
vocabulary at tp = 2, a ``d_ff`` the degree does not divide) runs whole:
its lookup or its MLP is local, and has no collective.

Scope: every layer attention (``attn``, ``attn_dense``, ``local_attn``)
with a dense MLP, and plain token prompts. RG-LRU, RWKV-6 and MoE
layers, whose reference rules split the value dim, the width and the
experts, and frontend or encoder-decoder models raise
``NotImplementedError`` (ROADMAP.md, Queue A item 8b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.launch.sharding import engine_param_shardings, shard_tree
from repro_torch.models.layers import apply_embed, apply_norm, unembed
from repro_torch.models.shard_hooks import all_gather, all_reduce
from repro_torch.models.transformer import (_lm_logits, attn_step_out,
                                            ffn_out, make_cache)

#: layer kinds the rank-split forward serves
TP_KINDS = ("attn", "attn_dense", "local_attn")

ITEM_8B = ("ROADMAP.md, Queue A item 8b, tensor parallelism for the "
           "recurrent, RWKV and MoE stacks")


def check_tp_config(cfg: ModelConfig, tp: int) -> None:
    """Raise unless the rank-split forward can serve ``cfg`` at degree
    ``tp``: an attention-only stack with dense MLPs, plain token prompts,
    and ``tp`` dividing the query and KV head counts (the reference's
    "must divide")."""
    if cfg.frontend is not None or cfg.enc_dec:
        raise NotImplementedError(
            "tensor-parallel serving needs the chunked-prefill path "
            "(frontend engines stay single-device)")
    bad = sorted({k for k in cfg.layer_kinds() if k not in TP_KINDS})
    if bad or cfg.n_experts:
        what = ", ".join(bad + (["moe"] if cfg.n_experts else []))
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over {what} layers is not "
            f"ported yet ({ITEM_8B})")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"{cfg.name}: tp_degree {tp} must divide n_heads "
            f"{cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} "
            "(the KV pool is head-sharded over the model axis)")


def _on(batch: Dict, device: torch.device) -> Dict:
    return {k: v.to(device) for k, v in batch.items()}


@dataclasses.dataclass
class TPModel:
    """``Model``'s serving API (``prefill_chunk``, ``decode_step``,
    ``verify_step``, ``init_cache``, ``init_paged_cache``) over per-rank
    params and caches: lists in rank order. Logits come back whole, on
    rank 0's device."""
    cfg: ModelConfig
    mesh: object

    def __post_init__(self):
        if "model" not in self.mesh.axis_names:
            raise ValueError(f"engine mesh needs a 'model' axis, got "
                             f"{self.mesh.axis_names}")
        if tuple(self.mesh.axis_names) != ("model",):
            raise ValueError(f"a serving mesh is ('model',) only, got "
                             f"{self.mesh.axis_names}")
        self.tp = int(self.mesh.shape["model"])
        check_tp_config(self.cfg, self.tp)
        self.devices = tuple(self.mesh.devices)
        cfg = self.cfg
        self.shard_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.tp,
            n_kv_heads=cfg.n_kv_heads // self.tp,
            d_ff=cfg.d_ff // self.tp if cfg.d_ff % self.tp == 0
            else cfg.d_ff)

    # ---- params --------------------------------------------------------
    def shard_params(self, params: Dict) -> List[Dict]:
        """The full params (the port's layout) cut into one tree per
        rank under ``engine_param_shardings``."""
        return shard_tree(params, engine_param_shardings(self.mesh, params),
                          self.mesh)

    def _split(self, params: List[Dict]) -> Tuple[bool, bool, List[bool]]:
        """(embedding split, head split, per-layer MLP split) read off the
        shards: a leaf is split where rank 0 holds less than the whole."""
        p0, cfg = params[0], self.cfg
        embed = p0["embed"].shape[0] != cfg.vocab_size
        head = embed if cfg.tie_embeddings \
            else p0["lm_head"].shape[1] != cfg.vocab_size
        mlp = [layer["ffn"]["w_down"].shape[0] != (
            (cfg.dense_ff or cfg.d_ff) if kind == "attn_dense" else cfg.d_ff)
            for layer, kind in zip(p0["layers"], cfg.layer_kinds())]
        return embed, head, mlp

    # ---- caches --------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   device=None) -> List[List[Dict]]:
        """One dense decode cache per rank, at the rank's head count on
        its device (``device`` is the mesh's, whatever is passed)."""
        return [make_cache(self.shard_cfg, batch, cache_len, dtype,
                           device=d) for d in self.devices]

    def init_paged_cache(self, batch: int, cache_len: int, n_blocks: int,
                         block_size: int, dtype=torch.float32,
                         device=None) -> List[List[Dict]]:
        """One paged decode cache per rank: each rank's block pool holds
        its heads of every block (one block table serves them all)."""
        return [make_cache(self.shard_cfg, batch, cache_len, dtype,
                           paged=(n_blocks, block_size), device=d)
                for d in self.devices]

    # ---- forward -------------------------------------------------------
    def _embed(self, params: List[Dict], tokens: List[torch.Tensor],
               split: bool) -> List[torch.Tensor]:
        if not split:
            return [apply_embed(p["embed"], t)
                    for p, t in zip(params, tokens)]
        parts = []
        for r, (p, t) in enumerate(zip(params, tokens)):
            n = p["embed"].shape[0]
            lo = r * n
            mine = (t >= lo) & (t < lo + n)
            rows = F.embedding((t - lo).clamp(0, n - 1), p["embed"])
            parts.append(torch.where(mine[..., None], rows,
                                     torch.zeros_like(rows)))
        return all_reduce(parts)

    def _logits(self, params: List[Dict], xs: List[torch.Tensor],
                split: bool) -> torch.Tensor:
        cfg = self.cfg
        if not split:
            return _lm_logits(params[0], xs[0], cfg)
        parts = []
        for p, x in zip(params, xs):
            h = apply_norm(p["final_norm"], x, cfg.norm)
            head = p["embed"] if cfg.tie_embeddings else p["lm_head"]
            parts.append(unembed(h, head, cfg.tie_embeddings,
                                 cfg.logit_softcap))
        return all_gather(parts, -1)[0]

    def _trunk(self, params: List[Dict], caches: List[List[Dict]],
               batch: Dict, decode: bool, last: bool) -> torch.Tensor:
        embed_split, head_split, mlp_split = self._split(params)
        batches = [_on(batch, d) for d in self.devices]
        xs = self._embed(params, [b["tokens"] for b in batches],
                         embed_split)
        cfg = self.shard_cfg
        for i, kind in enumerate(cfg.layer_kinds()):
            outs = all_reduce([
                attn_step_out(p["layers"][i], x, cfg, kind, c[i], b, decode)
                for p, x, c, b in zip(params, xs, caches, batches)])
            xs = [x + o for x, o in zip(xs, outs)]
            ys = [ffn_out(p["layers"][i], x, cfg, kind)[0]
                  for p, x in zip(params, xs)]
            if mlp_split[i]:
                ys = all_reduce(ys)
            xs = [x + y for x, y in zip(xs, ys)]
        if last:
            xs = [x[:, -1:, :] for x in xs]
        return self._logits(params, xs, head_split)

    @torch.no_grad()
    def prefill_chunk(self, params: List[Dict], cache: List[List[Dict]],
                      batch: Dict
                      ) -> Tuple[torch.Tensor, List[List[Dict]]]:
        """``Model.prefill_chunk`` over the ranks: last-position logits
        (B,1,V) on rank 0's device, every rank's cache updated in
        place."""
        return self._trunk(params, cache, batch, False, True), cache

    @torch.no_grad()
    def verify_step(self, params: List[Dict], cache: List[List[Dict]],
                    batch: Dict) -> Tuple[torch.Tensor, List[List[Dict]]]:
        """``Model.verify_step`` over the ranks: logits at every position
        (B,W,V)."""
        return self._trunk(params, cache, batch, False, False), cache

    @torch.no_grad()
    def decode_step(self, params: List[Dict], cache: List[List[Dict]],
                    batch: Dict) -> Tuple[torch.Tensor, List[List[Dict]]]:
        """``Model.decode_step`` over the ranks: logits (B,1,V)."""
        return self._trunk(params, cache, batch, True, False), cache
