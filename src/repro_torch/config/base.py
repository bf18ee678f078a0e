"""Model config dataclass: the port's own copy of the reference
``ModelConfig`` (field for field, so ``dataclasses.asdict`` of one builds
the other). ``InputShape`` and ``ServingConfig`` come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # citation from the assignment table

    # trunk dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention flavour
    rope: str = "rope"  # rope | rope2d | mrope | none
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full attention
    rope_theta: float = 10_000.0

    # per-layer block pattern, cycled over layers. entries:
    #   "attn" (global; MoE FFN when n_experts > 0), "attn_dense" (global
    #   attention with a dense FFN even in MoE models — llama4 interleave),
    #   "local_attn" (windowed), "rglru" (RG-LRU), "rwkv"
    block_pattern: Tuple[str, ...] = ("attn",)

    # MoE
    n_experts: int = 0  # 0 = dense FFN
    top_k: int = 1
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel w/ MoE
    dense_ff: Optional[int] = None  # width of the dense residual MLP
    capacity_factor: float = 1.25

    # encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
    frontend_tokens: int = 0  # stub embeddings prepended at prefill

    # misc
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu | gelu
    tie_embeddings: bool = False
    rwkv_head_size: int = 64
    rglru_width: Optional[int] = None  # RG-LRU recurrent width (default d_model)
    logit_softcap: Optional[float] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family in ("vlm", "audio") and self.frontend is None:
            object.__setattr__(
                self, "frontend", "vision" if self.family == "vlm" else "audio"
            )
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads={self.n_heads} not divisible by "
            f"n_kv_heads={self.n_kv_heads}"
        )

    # ---- derived ------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv", "rglru") for k in self.layer_kinds())

    @property
    def subquadratic(self) -> bool:
        """True if no layer attends over unbounded context."""
        for k in self.layer_kinds():
            if k in ("attn", "attn_dense") and self.sliding_window is None:
                return False
        return True

    def param_count_estimate(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings + trunk), used for rooflines.

        ``active_only`` counts only the routed experts a token actually
        uses (top_k of n_experts) — the MoE "active params" figure.
        """
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn_p = (d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                  + hd * self.n_heads * d)
        gated = self.activation in ("silu", "geglu")
        n_mats = 3 if gated else 2

        def dense_ffn(width):
            return n_mats * d * width

        moe_ffn = 0
        if self.n_experts:
            n_e = self.top_k if active_only else self.n_experts
            moe_ffn = n_e * 3 * d * self.d_ff + d * self.n_experts
            if self.moe_dense_residual:
                moe_ffn += 3 * d * (self.dense_ff or self.d_ff)

        total = emb
        rec_w = self.rglru_width or d
        for k in self.layer_kinds():
            if k in ("attn", "local_attn"):
                total += attn_p
                total += moe_ffn if self.n_experts else dense_ffn(self.d_ff)
            elif k == "attn_dense":
                total += attn_p + dense_ffn(self.dense_ff or self.d_ff)
            elif k == "rglru":
                total += (2 * d * rec_w + 2 * rec_w * rec_w + 4 * rec_w
                          + rec_w * d) + dense_ffn(self.d_ff)
            elif k == "rwkv":
                total += (6 * d * d + 10 * d * 32          # time mix
                          + 2 * d * self.d_ff + d * d)     # channel mix
        if self.enc_dec:
            total += self.n_enc_layers * (attn_p + dense_ffn(self.d_ff))
            total += self.n_layers * attn_p  # decoder cross-attention
        return int(total)
