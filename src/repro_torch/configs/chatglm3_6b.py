"""ChatGLM3-6B [arXiv:2406.12793] — GQA(kv=2), GLM-style partial ("2d")
rotary on half the head dim, swiGLU FFN."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=65_024,
    rope="rope2d",
    activation="silu",
    norm="rmsnorm",
))
