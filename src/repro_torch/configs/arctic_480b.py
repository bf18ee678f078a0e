"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: every layer has a 128-expert top-2 MoE *in parallel with* a dense
residual MLP branch."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,            # expert width
    dense_ff=7168,        # parallel dense residual MLP width
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    rope="rope",
    activation="silu",
    norm="rmsnorm",
))
