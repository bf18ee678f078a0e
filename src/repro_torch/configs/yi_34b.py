"""Yi-34B [arXiv:2403.04652] — llama-architecture dense, GQA(kv=8)."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="yi-34b",
    family="dense",
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    rope="rope",
    rope_theta=5_000_000.0,
    activation="silu",
    norm="rmsnorm",
))
