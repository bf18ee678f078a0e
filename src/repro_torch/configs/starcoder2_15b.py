"""StarCoder2-15B [arXiv:2402.19173] — GQA(kv=4), RoPE, 4k sliding window
(the model card trains with window attention, which also makes long_500k
lowerable for this dense arch)."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    rope="rope",
    rope_theta=100_000.0,
    sliding_window=4096,
    activation="gelu",   # plain (ungated) MLP, 4x width
    norm="layernorm",
))
