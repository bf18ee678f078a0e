"""Ported architecture configs, copies of the reference's. Importing this
package registers them with ``repro_torch.config.registry``; select via
``--arch <id>``. ``ASSIGNED`` lists the ten assigned architectures, as
the reference's package does."""
from repro_torch.configs import arctic_480b  # noqa: F401
from repro_torch.configs import chatglm3_6b  # noqa: F401
from repro_torch.configs import llama4_maverick_400b  # noqa: F401
from repro_torch.configs import qwen2_vl_7b  # noqa: F401
from repro_torch.configs import qwen3_0_6b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import rwkv6_3b  # noqa: F401
from repro_torch.configs import seamless_m4t_large_v2  # noqa: F401
from repro_torch.configs import starcoder2_15b  # noqa: F401
from repro_torch.configs import yi_34b  # noqa: F401

#: the ten pool-assigned architectures (paper's own edge models excluded)
ASSIGNED = [
    "llama4-maverick-400b-a17b",
    "rwkv6-3b",
    "starcoder2-15b",
    "qwen2-vl-7b",
    "recurrentgemma-2b",
    "chatglm3-6b",
    "seamless-m4t-large-v2",
    "yi-34b",
    "arctic-480b",
    "qwen3-0.6b",
]
