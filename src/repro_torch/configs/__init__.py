"""Ported architecture configs. Importing this package registers them with
``repro_torch.config.registry``; select via ``--arch <id>``. Only
``qwen3-0.6b`` is ported so far; the rest are listed in ROADMAP.md."""
from repro_torch.configs import qwen3_0_6b  # noqa: F401
