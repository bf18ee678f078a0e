"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

MoE with 128 routed experts, top-1 routing, interleaved dense/MoE layers
(every second layer routed — that interleave is what lands total params at
~400B with 17B active). Early-fusion multimodality is out of backbone scope
(the assignment tags this [moe], not [vlm]).
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,           # routed expert width
    dense_ff=16384,      # dense-layer FFN width
    vocab_size=202_048,
    n_experts=128,
    top_k=1,
    block_pattern=("attn_dense", "attn"),  # dense / MoE interleave
    rope="rope",
    rope_theta=500_000.0,
    activation="silu",
    norm="rmsnorm",
))
