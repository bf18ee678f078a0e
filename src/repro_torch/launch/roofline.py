"""Roofline analysis on an H100: the port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (chips * PEAK_FLOPS)
    memory     = HBM bytes / (chips * HBM_BW)
    collective = collective bytes per chip / LINK_BW

FLOPs and HBM bytes come from the reference's ANALYTIC workload model,
copied unchanged (``WorkloadCost``, ``_layer_flops_per_token``,
``workload_cost``), so they equal the reference's for every arch and
shape. The reference parses its collective bytes out of XLA's
partitioned HLO (``parse_collectives``); the port has no HLO, so
``collective_bytes`` COUNTS them from the sharding rules instead, per
chip, as stated there. Nothing here is measured.

Hardware constants: NVIDIA's H100 SXM data sheet (figures from the data
sheet, not measured), in place of the reference's TPU v5e constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config.base import InputShape, ModelConfig

#: H100 SXM dense bf16 tensor-core peak (data sheet; the counterpart of
#: v5e's bf16 197e12)
PEAK_FLOPS = 989e12
#: H100 SXM fp32 peak outside the tensor cores (data sheet): the bound of
#: the port's fp32 kernels
FP32_PEAK_FLOPS = 67e12
#: H100 SXM HBM3 bandwidth (data sheet)
HBM_BW = 3.35e12
#: NVLink 4, one direction: 900 GB/s bidirectional per GPU (data sheet)
LINK_BW = 450e9


# =====================================================================
# analytic workload model
# =====================================================================
@dataclasses.dataclass
class WorkloadCost:
    flops: float            # total FLOPs for the step (global)
    hbm_bytes: float        # total HBM traffic for the step (global)
    model_flops: float      # 6*N*D (train) / 2*N*D (inference) reference
    param_bytes: float

    def terms(self, chips: int, collective_bytes_per_chip: float,
              dtype_bytes: int = 2) -> Dict[str, float]:
        return {
            "compute_s": self.flops / (chips * PEAK_FLOPS),
            "memory_s": self.hbm_bytes / (chips * HBM_BW),
            "collective_s": collective_bytes_per_chip / LINK_BW,
            "model_flops": self.model_flops,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
        }


def _layer_flops_per_token(cfg: ModelConfig, kind: str, ctx_len: float,
                           decode: bool) -> float:
    """Forward FLOPs per token for one layer of ``kind``."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    f = cfg.d_ff
    fl = 0.0
    if kind in ("attn", "attn_dense", "local_attn"):
        fl += 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d  # qkvo
        fl += 4 * ctx_len * H * hd                                   # scores+values
        if cfg.enc_dec:  # cross attention
            enc_len = ctx_len / 4
            fl += 2 * d * H * hd + 2 * H * hd * d + 4 * enc_len * H * hd
        if cfg.n_experts and kind != "attn_dense":
            fl += 2 * d * cfg.n_experts                              # router
            fl += cfg.top_k * (3 if cfg.activation in ("silu", "geglu")
                               else 2) * 2 * d * f
            if cfg.moe_dense_residual:
                fl += 3 * 2 * d * (cfg.dense_ff or f)
        else:
            width = (cfg.dense_ff or f) if kind == "attn_dense" else f
            n_mats = 3 if cfg.activation in ("silu", "geglu") else 2
            fl += n_mats * 2 * d * width
    elif kind == "rwkv":
        fl += 5 * 2 * d * d + 2 * d * d        # r/k/v/g/o + W_o
        fl += 10 * 2 * d * 32                  # token-shift loras
        fl += 5 * d * hd                       # wkv recurrence per token
        fl += 2 * 2 * d * cfg.d_ff + 2 * d * d  # channel mix
    elif kind == "rglru":
        w = cfg.rglru_width or d
        fl += 2 * 2 * d * w + 2 * 2 * w * w + 2 * 4 * w + 6 * w + 2 * w * d
        n_mats = 3 if cfg.activation in ("silu", "geglu") else 2
        fl += n_mats * 2 * d * cfg.d_ff
    return fl


def workload_cost(cfg: ModelConfig, shape: InputShape,
                  dtype_bytes: int = 2) -> WorkloadCost:
    B, S = shape.global_batch, shape.seq_len
    kinds = cfg.layer_kinds()
    params = cfg.param_count_estimate()
    active_params = cfg.param_count_estimate(active_only=True)
    p_bytes = params * dtype_bytes

    if shape.kind == "decode":
        n_tok = B  # one token per sequence
        fl = 0.0
        for kind in kinds:
            ctx = S
            if kind == "local_attn" or cfg.sliding_window:
                ctx = min(S, cfg.sliding_window or 2048)
            if kind in ("rwkv", "rglru"):
                ctx = 0
            fl += n_tok * _layer_flops_per_token(cfg, kind, ctx, True)
        fl += n_tok * 2 * cfg.d_model * cfg.vocab_size
        # HBM: weights (active experts only for small batches) + cache
        expert_frac = min(1.0, B * cfg.top_k / max(cfg.n_experts, 1)) \
            if cfg.n_experts else 1.0
        moe_bytes = (params - active_params) * 0  # handled via frac below
        w_bytes = p_bytes if not cfg.n_experts else (
            active_params * dtype_bytes
            + (params - active_params) * dtype_bytes * expert_frac)
        cache_bytes = 0.0
        for kind in kinds:
            if kind in ("attn", "attn_dense", "local_attn"):
                ctx = min(S, cfg.sliding_window or S)
                if kind == "local_attn":
                    ctx = min(S, cfg.sliding_window or 2048)
                cache_bytes += 2 * B * ctx * cfg.n_kv_heads * cfg.head_dim \
                    * dtype_bytes
            elif kind == "rwkv":
                hd = cfg.rwkv_head_size
                cache_bytes += B * (cfg.d_model // hd) * hd * hd * 4
            elif kind == "rglru":
                cache_bytes += B * (cfg.rglru_width or cfg.d_model) * 4
        hbm = w_bytes + cache_bytes + n_tok * cfg.d_model * dtype_bytes * \
            len(kinds) * 8
        model_fl = 2 * active_params * n_tok
        return WorkloadCost(fl, hbm, model_fl, p_bytes)

    # train / prefill: N = B*S tokens
    n_tok = B * S
    fl = 0.0
    for kind in kinds:
        ctx = S / 2  # causal average
        if kind == "local_attn" or cfg.sliding_window:
            ctx = min(S / 2, (cfg.sliding_window or 2048))
        if kind in ("rwkv", "rglru"):
            ctx = 0
        fl += n_tok * _layer_flops_per_token(cfg, kind, ctx, False)
    if cfg.enc_dec:
        enc_tok = B * (S // 4)
        for _ in range(cfg.n_enc_layers):
            fl += enc_tok * _layer_flops_per_token(
                dataclasses.replace(cfg, enc_dec=False), "attn", S / 8,
                False)
    if shape.kind == "train":
        fl += n_tok * 2 * cfg.d_model * cfg.vocab_size  # lm head
        fl *= 3  # fwd + bwd
        acts = 2 * n_tok * cfg.d_model * dtype_bytes * len(kinds) * 10
        hbm = 3 * p_bytes + 2 * p_bytes * 2 + acts  # w fwd/bwd + opt + acts
        model_fl = 6 * active_params * n_tok
    else:  # prefill
        fl += B * 2 * cfg.d_model * cfg.vocab_size  # last-token logits
        acts = 2 * n_tok * cfg.d_model * dtype_bytes * len(kinds) * 6
        hbm = p_bytes + acts
        model_fl = 2 * active_params * n_tok
    return WorkloadCost(fl, hbm, model_fl, p_bytes)


# =====================================================================
# collective bytes, counted
# =====================================================================
def _ring(n: int) -> float:
    """Bytes a ring all-reduce over ``n`` chips moves per chip, per byte
    of payload."""
    return 2.0 * (n - 1) / n


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def collective_bytes(cfg: ModelConfig, shape: InputShape, mesh,
                     mode: str = "tp", dtype_bytes: int = 2, *,
                     param_bytes_per_chip: float) -> Dict[str, float]:
    """Collective bytes one chip moves for one step of ``shape`` on
    ``mesh`` under the launch rules (``launch.sharding``), COUNTED, not
    parsed from a compiled program:

    * two all-reduces per layer over ``model`` (each layer's two residual
      sub-blocks end in a row-split projection, ``wo`` and ``w_down``, or
      their recurrent and expert counterparts), each of the local batch's
      activations, (local batch) x (tokens per sequence: 1 in decode) x
      ``d_model`` x ``dtype_bytes``, at the ring factor 2(n-1)/n;
    * a training step's backward: the same again;
    * a training step's gradient all-reduce over the batch axes, of
      ``param_bytes_per_chip`` (one chip's params split over ``model``
      alone), ring factor over the batch axes; in ``2d`` it is a reduce-scatter, half that;
    * in ``2d`` and ``decode2d``, the weights' all-gather over ``data``
      before use, (n-1)/n of ``param_bytes_per_chip``.

    Left out: the vocabulary-split embedding's all-reduce and the head's
    all-gather, an encoder's and cross-attention's all-reduces, and
    MoE's dispatch (an all-to-all, counted here as the layer's
    all-reduce). The batch is local where the batch axes divide it
    (``decode2d`` replicates it). Returns the bytes by kind and
    ``total_bytes``."""
    n_model = mesh.shape.get("model", 1)
    b_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    n_batch = _axes_size(mesh, b_axes)
    B = shape.global_batch
    local_b = B if mode == "decode2d" or B % n_batch else B // n_batch
    tokens = 1 if shape.kind == "decode" else shape.seq_len
    act = local_b * tokens * cfg.d_model * dtype_bytes
    reduce = cfg.n_layers * 2 * _ring(n_model) * act
    if shape.kind == "train":
        reduce *= 2
    scatter = gather = 0.0
    if shape.kind == "train" and n_batch > 1:
        grad = _ring(n_batch) * param_bytes_per_chip
        if mode == "2d":
            scatter = grad / 2
        else:
            reduce += grad
    n_data = mesh.shape.get("data", 1)
    if mode in ("2d", "decode2d") and n_data > 1:
        gather = (n_data - 1) / n_data * param_bytes_per_chip
    return {"all-reduce_bytes": reduce, "reduce-scatter_bytes": scatter,
            "all-gather_bytes": gather,
            "total_bytes": reduce + scatter + gather}
