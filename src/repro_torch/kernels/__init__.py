"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a wrapper
that launches it on CUDA tensors and a plain PyTorch version that CPU
tensors take. Kernels build with ``nvcc`` at first use (``_build``)."""
from repro_torch.kernels.decode_attention import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.prefill_attention import (  # noqa: F401
    paged_prefill_attention, paged_prefill_attention_plain)
