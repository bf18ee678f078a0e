"""PyTorch/CUDA port of the BCEdge serving stack, held against the JAX
package ``repro`` (the reference, which it never imports).

Ported so far: paged and dense continuous-batching serving and round-mode
serving with the discrete SAC scheduler over the dense, recurrent and MoE
families, the multi-model instance pool, and the edge-serving simulator
with the baseline schedulers (``repro_torch.launch.serve`` without
``--engine``), and the training substrate (``repro_torch.train``,
``repro_torch.launch.train``), with hand-written CUDA kernels for every
TPU kernel of the reference. What is still to port is listed in
ROADMAP.md.
"""
