"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family] — qk_norm (RMSNorm on per-head q/k),
GQA(kv=8), head_dim 128 decoupled from d_model, tied embeddings."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    rope="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    activation="silu",
    norm="rmsnorm",
))
