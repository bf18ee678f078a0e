"""The rank-split forward: tensor-parallel serving of a decoder over a
``("model",)`` mesh (``repro_torch.launch.mesh``).

The reference serves a tensor-parallel instance with ``jit`` under
``NamedSharding`` in/out specs (``serving/engine.py:999-1024``) and lets
GSPMD partition the step. The port runs the partition itself, from one
process: each rank holds the shard of every weight that
``engine_param_shardings`` gives it (and the cuts below) and its slice of
the decode cache, each on its rank's device, and every step runs the
ranks in lockstep. The collectives (``models.shard_hooks``) are the only
points where ranks meet. A rank's shard config is ``cfg`` with
``n_heads``, ``n_kv_heads``, ``d_ff`` (where the MLP splits) and the
RG-LRU width divided by the degree, so each kernel launches once per
rank per layer at the rank's shape.

Per layer kind:

* Attention (``attn``, ``attn_dense``, ``local_attn``): heads split; one
  all-reduce after the row-split ``wo``. Per-head qk-norm, RoPE, windows
  and rings stay within a rank.
* RG-LRU: ``W_x``, ``W_gate``, the conv, ``lam``, ``b_a``, ``b_i`` and
  the ``h``/``conv`` states split by width; the depthwise conv is local.
  One all-gather of u before the gate projections (the reference's own
  constraint, ``repro/models/rglru.py:88-92``), whose ``W_a``/``W_i``
  columns are then local; the scan runs at width w / tp, and one
  all-reduce follows the row-split ``W_o``.
* RWKV-6: split by HEAD. ``W_r``/``W_k``/``W_v``/``W_g`` columns and
  ``w_base`` over d give each rank whole heads, and ``ln_x`` normalises
  per head, so the time mix is local up to the row-split ``W_o`` and its
  all-reduce. The reference cuts ``u`` and ``att_state`` over hd_v
  (``sharding.py:63-64``, ``:233-234``); a value-dim cut would need the
  norm's statistics all-reduced in every layer and step, so this module
  cuts them by head instead (the same bytes a rank). The shifts stay
  whole: they feed the replicated token-shift LoRAs. The channel mix
  all-reduces ``k @ W_v`` (row-split over d_ff) and all-gathers
  ``sigmoid(xr @ W_r)`` (column-split over d) before their product.
* MoE: the experts split over E, the router's columns with them. The
  router logits are all-gathered, so every rank routes every token as
  the unsplit layer does (capacity and drops over all E); each rank runs
  its experts' entries through ``moe_matmul`` at E / tp, and one
  all-reduce sums the experts' and the dense residual's partials.
* The MLP: columns of ``w_up``/``w_gate`` and rows of ``w_down``; one
  all-reduce.

A vocabulary-split embedding looks up the rows in the rank's range (zeros
elsewhere) and all-reduces them; a vocabulary-split head all-gathers its
logits before sampling. A leaf ``_fit_mesh`` leaves replicated (TINY's
97-entry vocabulary at tp = 2, a ``d_ff`` or an expert count the degree
does not divide) runs whole on every rank: that sub-block is local and
has no collective. Frontend and encoder-decoder models stay
single-device, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.launch.sharding import M, engine_param_shardings, shard_tree
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       unembed)
from repro_torch.models.shard_hooks import all_gather, all_reduce
from repro_torch.models.transformer import (_is_moe, _lm_logits,
                                            attn_step_out, make_cache)


def check_tp_config(cfg: ModelConfig, tp: int) -> None:
    """Raise unless the rank-split forward can serve ``cfg`` at degree
    ``tp``: plain token prompts, and ``tp`` dividing the query and KV head
    counts (the reference's "must divide") and an RWKV-6 stack's head
    count (the time mix splits by head)."""
    if cfg.frontend is not None or cfg.enc_dec:
        raise NotImplementedError(
            "tensor-parallel serving needs the chunked-prefill path "
            "(frontend engines stay single-device)")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"{cfg.name}: tp_degree {tp} must divide n_heads "
            f"{cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} "
            "(the KV pool is head-sharded over the model axis)")
    heads = cfg.d_model // cfg.rwkv_head_size
    if "rwkv" in cfg.layer_kinds() and heads % tp:
        raise ValueError(
            f"{cfg.name}: tp_degree {tp} must divide the RWKV-6 head count "
            f"{heads} (the time mix is split by head)")


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
        cfg, tp = self.cfg, self.tp
        width = cfg.rglru_width or cfg.d_model

        def cut(n):
            return n // tp if n % tp == 0 else n
        self.shard_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
            d_ff=cut(cfg.d_ff), rglru_width=cut(width))
        #: an RWKV-6 rank's heads (``check_tp_config`` makes tp divide them)
        self.rwkv_heads = cfg.d_model // cfg.rwkv_head_size // tp

    # ---- params --------------------------------------------------------
    def shard_params(self, params: Dict, consume: bool = False
                     ) -> List[Dict]:
        """The full params (the port's layout) cut into one tree per rank
        under ``engine_param_shardings``, with an RWKV-6 layer's ``u``
        (H, hd) cut by head where the reference's spec cuts hd (the
        module docstring says why). ``consume`` empties ``params`` leaf by
        leaf as it goes (``shard_tree``), so the whole tree and the
        shards never coexist beyond one leaf."""
        specs = engine_param_shardings(self.mesh, params)
        for spec, kind in zip(specs["layers"], self.cfg.layer_kinds()):
            if kind == "rwkv":
                spec["time_mix"]["u"] = (M, None)
        return shard_tree(params, specs, self.mesh, consume=consume)

    def _head_split(self, params: List[Dict]) -> Tuple[bool, bool]:
        """(embedding split, head split) read off the shards: a leaf is
        split where rank 0 holds less than the whole."""
        p0, cfg = params[0], self.cfg
        embed = p0["embed"].shape[0] != cfg.vocab_size
        head = embed if cfg.tie_embeddings \
            else p0["lm_head"].shape[1] != cfg.vocab_size
        return embed, head

    def _layer_plan(self, layer: Dict, kind: str) -> Dict[str, bool]:
        """Which sub-blocks of a layer are split, read off rank 0's shard
        ``layer``: ``mlp``, ``experts`` and ``dense`` (an MoE layer's
        residual MLP), ``rec`` (the RG-LRU width), ``r`` and ``kv``
        (RWKV-6's channel-mix factors). Attention heads and an RWKV-6 time
        mix always split."""
        cfg = self.cfg
        if kind == "rwkv":
            cm = layer["channel_mix"]
            return {"r": cm["W_r"].shape[1] != cfg.d_model,
                    "kv": cm["W_v"].shape[0] != cfg.d_ff}
        plan, ffn = {}, layer["ffn"]
        if kind == "rglru":
            plan["rec"] = layer["rec"]["W_x"].shape[1] != (
                cfg.rglru_width or cfg.d_model)
        if _is_moe(cfg, kind):
            plan["experts"] = ffn["w_gate"].shape[0] != cfg.n_experts
            if "dense_mlp" in ffn:
                plan["dense"] = ffn["dense_mlp"]["w_down"].shape[0] != (
                    cfg.dense_ff or cfg.d_ff)
        else:
            plan["mlp"] = ffn["w_down"].shape[0] != (
                (cfg.dense_ff or cfg.d_ff) if kind == "attn_dense"
                else cfg.d_ff)
        return plan

    # ---- caches --------------------------------------------------------
    def _caches(self, batch: int, cache_len: int, dtype, paged=None
                ) -> List[List[Dict]]:
        """One decode cache per rank on its device, at the shard config's
        heads and RG-LRU width; an RWKV-6 layer's ``att_state`` holds the
        rank's heads, its shifts the whole d."""
        out = []
        for dev in self.devices:
            cache = make_cache(self.shard_cfg, batch, cache_len, dtype,
                               paged=paged, device=dev)
            for c, kind in zip(cache, self.cfg.layer_kinds()):
                if kind == "rwkv":
                    c.update(rk.rwkv_state_init(self.cfg, batch, dtype, dev,
                                                n_heads=self.rwkv_heads))
            out.append(cache)
        return out

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   device=None) -> List[List[Dict]]:
        """One dense decode cache per rank, at the rank's head count and
        width on its device (``device`` is the mesh's, whatever is
        passed)."""
        return self._caches(batch, cache_len, dtype)

    def init_paged_cache(self, batch: int, cache_len: int, n_blocks: int,
                         block_size: int, dtype=torch.float32,
                         device=None) -> List[List[Dict]]:
        """One paged decode cache per rank: each rank's block pool holds
        its heads of every block (one block table serves them all), its
        rings and recurrent states their per-slot rows beside it."""
        return self._caches(batch, cache_len, dtype,
                            paged=(n_blocks, block_size))

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

    def _norm(self, ps: List[Dict], xs: List[torch.Tensor],
              *keys: str) -> List[torch.Tensor]:
        """Each rank's copy of x through the (replicated) norm at
        ``ps[r][keys...]``."""
        out = []
        for p, x in zip(ps, xs):
            for k in keys:
                p = p[k]
            out.append(apply_norm(p, x, self.cfg.norm))
        return out

    def _rglru(self, ps: List[Dict], xs: List[torch.Tensor],
               cs: List[Dict], decode: bool, split: bool
               ) -> List[torch.Tensor]:
        """The RG-LRU block's output on every rank (the residual's
        addend); each rank's ``h`` and ``conv`` replaced in its cache."""
        hs = self._norm(ps, xs, "rec", "norm")
        conv = [rg.rglru_conv(p["rec"], h, c, decode)
                for p, h, c in zip(ps, hs, cs)]
        us = [u for u, _ in conv]
        u_ins = all_gather(us, -1) if split else us
        mixed = [rg.rglru_mix(p["rec"], h, u_in, u, c, decode)
                 for p, h, u_in, u, c in zip(ps, hs, u_ins, us, cs)]
        for c, (_, new_conv), (_, new_h) in zip(cs, conv, mixed):
            c.update(h=new_h, conv=new_conv)
        outs = [out for out, _ in mixed]
        return all_reduce(outs) if split else outs

    def _rwkv(self, ps: List[Dict], xs: List[torch.Tensor],
              cs: List[Dict], decode: bool, split: Dict
              ) -> List[torch.Tensor]:
        """The residual RWKV-6 block (time mix, then channel mix) on every
        rank; each rank's state replaced in its cache. Rank r's heads
        start at channel r * H/tp * hd."""
        cfg = self.cfg
        fn = rk.time_mix_decode if decode else rk.time_mix_seq
        hs = self._norm(ps, xs, "time_mix", "norm")
        n = self.rwkv_heads * cfg.rwkv_head_size
        mixed = [fn(p["time_mix"], h, cfg, c["att_state"], c["att_shift"],
                    lo=r * n)
                 for r, (p, h, c) in enumerate(zip(ps, hs, cs))]
        att = all_reduce([out for out, _, _ in mixed])
        xs = [x + a for x, a in zip(xs, att)]
        hs = self._norm(ps, xs, "channel_mix", "norm")
        parts = [rk.channel_mix_parts(p["channel_mix"], h, c["ffn_shift"])
                 for p, h, c in zip(ps, hs, cs)]
        rs = [r for r, _, _ in parts]
        kvs = [kv for _, kv, _ in parts]
        rs = all_gather(rs, -1) if split["r"] else rs
        kvs = all_reduce(kvs) if split["kv"] else kvs
        for c, (_, state, shift), (_, _, ffn_shift) in zip(cs, mixed, parts):
            c.update(att_state=state, att_shift=shift, ffn_shift=ffn_shift)
        return [x + r * kv for x, r, kv in zip(xs, rs, kvs)]

    def _ffn(self, ps: List[Dict], xs: List[torch.Tensor], kind: str,
             split: Dict) -> List[torch.Tensor]:
        """The residual FFN sub-block on every rank: the MLP, or the
        experts (with arctic's dense residual MLP beside them)."""
        cfg = self.cfg
        hs = self._norm(ps, xs, "ffn_norm")
        if not _is_moe(cfg, kind):
            ys = [apply_mlp(p["ffn"], h, cfg.activation)
                  for p, h in zip(ps, hs)]
            ys = all_reduce(ys) if split["mlp"] else ys
            return [x + y for x, y in zip(xs, ys)]
        B, S, d = hs[0].shape
        xfs = [h.reshape(B * S, d) for h in hs]
        logits = [(xf @ p["ffn"]["router"]).float()
                  for p, xf in zip(ps, xfs)]
        if split["experts"]:
            logits = all_gather(logits, -1)
        ys = []
        for r, (p, xf, lg) in enumerate(zip(ps, xfs, logits)):
            e0 = r * p["ffn"]["w_gate"].shape[0] if split["experts"] else 0
            ys.append(moe.experts_out(p["ffn"], xf, moe.route(lg, cfg), cfg,
                                      e0))
        reduce = split["experts"]
        if cfg.moe_dense_residual:
            ds = [apply_mlp(p["ffn"]["dense_mlp"], xf, cfg.activation)
                  for p, xf in zip(ps, xfs)]
            if split["dense"] == reduce:  # one all-reduce (or none) of both
                ys = [y + dd for y, dd in zip(ys, ds)]
            else:  # reduce the split one alone, add the whole one
                part, whole = (ys, ds) if reduce else (ds, ys)
                ys = [a + b for a, b in zip(all_reduce(part), whole)]
                reduce = False
        ys = all_reduce(ys) if reduce else ys
        return [x + y.reshape(B, S, d) for x, y in zip(xs, ys)]

    def layer(self, ps: List[Dict], xs: List[torch.Tensor],
              cs: List[Dict], batches: List[Dict], kind: str,
              decode: bool) -> List[torch.Tensor]:
        """One layer of ``kind`` over the ranks: each rank's shard of its
        params ``ps[r]``, copy of the residual stream ``xs[r]`` (B,S,d),
        cache ``cs[r]`` (updated in place) and batch ``batches[r]`` (the
        attention's ``pos`` and block tables). Returns each rank's copy of
        the layer's output, the residual included."""
        split = self._layer_plan(ps[0], kind)
        if kind == "rwkv":
            return self._rwkv(ps, xs, cs, decode, split)
        if kind == "rglru":
            outs = self._rglru(ps, xs, cs, decode, split["rec"])
        else:
            outs = all_reduce([
                attn_step_out(p, x, self.shard_cfg, kind, c, b, decode)
                for p, x, c, b in zip(ps, xs, cs, batches)])
        xs = [x + o for x, o in zip(xs, outs)]
        return self._ffn(ps, xs, kind, split)

    def _trunk(self, params: List[Dict], caches: List[List[Dict]],
               batch: Dict, decode: bool, last: bool) -> torch.Tensor:
        embed_split, head_split = self._head_split(params)
        batches = [_on(batch, d) for d in self.devices]
        xs = self._embed(params, [b["tokens"] for b in batches],
                         embed_split)
        for i, kind in enumerate(self.cfg.layer_kinds()):
            xs = self.layer([p["layers"][i] for p in params], xs,
                            [c[i] for c in caches], batches, kind, decode)
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
