"""Ported architecture configs. Importing this package registers them with
``repro_torch.config.registry``; select via ``--arch <id>``. Ported so
far: ``qwen3-0.6b``, ``recurrentgemma-2b``, ``rwkv6-3b``, and the MoE
family, ``arctic-480b`` and ``llama4-maverick-400b-a17b``; the rest are
listed in ROADMAP.md."""
from repro_torch.configs import arctic_480b  # noqa: F401
from repro_torch.configs import llama4_maverick_400b  # noqa: F401
from repro_torch.configs import qwen3_0_6b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
