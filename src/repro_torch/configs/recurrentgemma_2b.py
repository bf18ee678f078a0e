"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427] — RG-LRU temporal blocks
with local attention every third layer (1 attn : 2 recurrent), MQA (kv=1),
window 2048. 26 layers = 8 (rglru, rglru, local_attn) units + a (rglru,
rglru) tail."""
import dataclasses

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import default_reduce, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        source="arXiv:2402.19427",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        block_pattern=("rglru", "rglru", "local_attn"),
        sliding_window=2048,
        rglru_width=2560,
        rope="rope",
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        logit_softcap=30.0,
    ),
    # 3 reduced layers so the smoke test exercises one full pattern unit
    reducer=lambda cfg: dataclasses.replace(default_reduce(cfg), n_layers=3),
)
