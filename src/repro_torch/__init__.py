"""PyTorch/CUDA port of the BCEdge serving stack, held against the JAX
package ``repro`` (the reference, which it never imports).

Ported so far: paged and dense continuous-batching serving and round-mode
serving with the discrete SAC scheduler, over the dense GQA decoder
(``qwen3-0.6b``, global and sliding-window attention), with hand-written
CUDA kernels for paged decode, paged chunk prefill, full-sequence flash
attention and dense-cache decode. What is still to port is listed in
ROADMAP.md.
"""
