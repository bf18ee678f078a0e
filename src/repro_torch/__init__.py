"""PyTorch/CUDA port of the BCEdge serving stack, held against the JAX
package ``repro`` (the reference, which it never imports).

Slice 1 covers the main path: paged continuous-batching serving of the
dense GQA decoder (``qwen3-0.6b``) with hand-written CUDA kernels for
paged decode and paged chunk-prefill attention. What is still to port is
listed in ROADMAP.md.
"""
