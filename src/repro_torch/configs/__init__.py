"""Ported architecture configs. Importing this package registers them with
``repro_torch.config.registry``; select via ``--arch <id>``. Ported so
far: ``qwen3-0.6b``, ``recurrentgemma-2b`` and ``rwkv6-3b``; the rest are
listed in ROADMAP.md."""
from repro_torch.configs import qwen3_0_6b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
