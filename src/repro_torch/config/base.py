"""Config dataclasses: the port's own copies of the reference's
``ModelConfig`` and ``ServingConfig`` (field for field, so
``dataclasses.asdict`` of one builds the other). ``InputShape`` comes
with a later slice.
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


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """BCEdge scheduler + serving layer parameters (paper §IV/§V-A); a copy
    of the reference's, with its action codecs.

    The scheduler's discrete action encodes, innermost first, the batch
    size b, the concurrency m_c, the per-iteration token budget (0 =
    uncapped), the speculation depth k and the tensor-parallel degree.
    Each wider codec keeps the narrower ones' digits, so the default
    single level of an outer axis leaves every action id unchanged.
    ``exec_mode`` selects round (run-to-completion batches, the paper's
    semantics) or continuous (iteration-level) execution. Out-of-range
    values raise ``ValueError``.
    """

    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    concurrency_levels: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8)
    arrival_rps: float = 30.0  # Poisson rate (paper: 30 rps)
    platform: str = "xavier_nx"
    slo_scale: float = 1.0  # multiply per-model SLOs (stress knob)
    max_queue: int = 512
    seed: int = 0
    use_interference_predictor: bool = True
    exec_mode: str = "round"  # "round" | "continuous"
    decode_steps_mean: float = 1.0  # mean decode iterations per request
    token_budgets: Tuple[int, ...] = (0,)
    prefill_tokens_mean: float = 0.0  # mean prompt tokens (0 = single-shot)
    preemption: bool = False  # SLO-aware eviction (continuous mode)
    preempt_margin_ms: float = 50.0  # victim must out-slack urgent by this
    max_preemptions: int = 2  # per-request cap (anti-thrash)
    shared_prefix_tokens: float = 0.0
    prefix_population: int = 4
    prefix_cache: bool = False
    spec_depths: Tuple[int, ...] = (0,)
    spec_accept_rate: float = 0.6
    tp_degrees: Tuple[int, ...] = (1,)

    def __post_init__(self):
        checks = (
            (self.exec_mode in ("round", "continuous"), "exec_mode"),
            (self.decode_steps_mean >= 1.0, "decode_steps_mean"),
            (len(self.token_budgets) > 0
             and all(t >= 0 for t in self.token_budgets), "token_budgets"),
            (self.prefill_tokens_mean >= 0.0, "prefill_tokens_mean"),
            (self.shared_prefix_tokens >= 0.0, "shared_prefix_tokens"),
            (self.prefix_population >= 1, "prefix_population"),
            (len(self.spec_depths) > 0
             and all(k >= 0 for k in self.spec_depths), "spec_depths"),
            (0.0 <= self.spec_accept_rate <= 1.0, "spec_accept_rate"),
            (len(self.tp_degrees) > 0
             and all(d >= 1 for d in self.tp_degrees), "tp_degrees"),
        )
        for ok, name in checks:
            if not ok:
                raise ValueError(f"ServingConfig.{name} out of range: "
                                 f"{getattr(self, name)!r}")

    @property
    def n_actions(self) -> int:
        return len(self.batch_sizes) * len(self.concurrency_levels) * \
            len(self.token_budgets) * len(self.spec_depths) * \
            len(self.tp_degrees)

    def action_to_pair(self, a: int) -> Tuple[int, int]:
        nb = len(self.batch_sizes)
        a = a % (nb * len(self.concurrency_levels))
        return self.batch_sizes[a % nb], self.concurrency_levels[a // nb]

    def pair_to_action(self, b: int, m_c: int) -> int:
        return self.concurrency_levels.index(m_c) * len(self.batch_sizes) + \
            self.batch_sizes.index(b)

    def action_to_triple(self, a: int) -> Tuple[int, int, int]:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        nt = len(self.token_budgets)
        a = a % (nb * nm * nt)
        b, m_c = self.action_to_pair(a)
        return b, m_c, self.token_budgets[a // (nb * nm)]

    def triple_to_action(self, b: int, m_c: int, token_budget: int) -> int:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        return self.token_budgets.index(token_budget) * nb * nm + \
            self.pair_to_action(b, m_c)

    def action_to_quad(self, a: int) -> Tuple[int, int, int, int]:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        nt, nk = len(self.token_budgets), len(self.spec_depths)
        a = a % (nb * nm * nt * nk)
        b, m_c, tb = self.action_to_triple(a)
        return b, m_c, tb, self.spec_depths[a // (nb * nm * nt)]

    def quad_to_action(self, b: int, m_c: int, token_budget: int,
                       spec_k: int) -> int:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        nt = len(self.token_budgets)
        return self.spec_depths.index(spec_k) * nb * nm * nt + \
            self.triple_to_action(b, m_c, token_budget)

    def action_to_quint(self, a: int) -> Tuple[int, int, int, int, int]:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        nt, nk = len(self.token_budgets), len(self.spec_depths)
        b, m_c, tb, sk = self.action_to_quad(a)
        return b, m_c, tb, sk, self.tp_degrees[a // (nb * nm * nt * nk)]

    def quint_to_action(self, b: int, m_c: int, token_budget: int,
                        spec_k: int, tp_degree: int) -> int:
        nb, nm = len(self.batch_sizes), len(self.concurrency_levels)
        nt, nk = len(self.token_budgets), len(self.spec_depths)
        return self.tp_degrees.index(tp_degree) * nb * nm * nt * nk + \
            self.quad_to_action(b, m_c, token_budget, spec_k)
