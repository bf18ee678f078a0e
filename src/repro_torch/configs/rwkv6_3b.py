"""RWKV-6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dependent
decay linear recurrence."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / rwkv_head_size
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    block_pattern=("rwkv",),
    rope="none",
    rwkv_head_size=64,
    norm="layernorm",
))
