"""Qwen2-VL-7B [arXiv:2409.12191] — M-RoPE (t/h/w factorised rotary),
dynamic-resolution ViT frontend. The ViT is a stub per the brief:
``input_specs`` supplies patch embeddings (B, F, d_model); the backbone
applies the learned projector + M-RoPE positions over the vision span.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=1024,   # stubbed patch-embedding span
    activation="silu",
    norm="rmsnorm",
))
