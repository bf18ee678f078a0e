"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a wrapper
that launches it on CUDA tensors and a plain PyTorch version that CPU
tensors take. Kernels build with ``nvcc`` at first use (``_build``).

The wrappers live in their modules: ``decode_attention`` (dense and
paged decode), ``flash_attention``, ``prefill_attention`` (paged
chunks), ``rglru_scan`` and ``rwkv6_scan`` (the recurrent families'
sequence forms) and ``moe_matmul`` (the MoE family's grouped expert
products). Import them from there: the dense kernels' functions share
their modules' names."""
