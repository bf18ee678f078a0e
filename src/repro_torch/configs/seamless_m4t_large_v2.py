"""SeamlessM4T-large-v2 [arXiv:2308.11596] — encoder-decoder multimodal
translator. Backbone only per the brief: the conformer speech frontend is a
stub; ``input_specs`` supplies frame embeddings (B, seq/4, d_model) to a
24-layer bidirectional encoder; the 24-layer decoder (self + cross attn)
is what decode shapes lower. MHA kv=16 (no grouping)."""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=24,            # decoder layers
    n_enc_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    # true vocab is 256206; padded +2 to a multiple of 16 so the embedding
    # shards evenly over the model axis (standard Megatron-style vocab pad)
    vocab_size=256_208,
    rope="rope",
    frontend="audio",
    activation="gelu",
    norm="layernorm",
))
