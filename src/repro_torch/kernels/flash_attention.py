"""Full-sequence flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas,
TPU), which ``attention_full`` runs under ``impl="kernel"``: query rows
at positions ``0..S-1`` attend K/V rows at positions ``0..T-1`` under
the causal and/or sliding-window mask, forward only (every prefill of
round mode). The Pallas grid ``(B, H, S / bq, T / bk)`` fetched each K/V
tile once per query head.

The kernel (``csrc/flash_attention.cu``) runs the prefill body of
``csrc/paged_attention.cuh``, the one paged prefill runs, over contiguous
K/V: one block of 256 threads per (sequence, KV head, tile of ``64 // G``
query rows) holds the tile for all ``G = H / KV`` heads of the group (64
score rows), streams K/V tiles of 64 slots (32 at hd 256) through a
two-stage ``cp.async`` ring, and computes both products in register
micro-tiles. It sweeps from the tile holding its first row's window edge
to its last row's causal limit, masks only the tiles that cross an edge,
zero-fills rows past T without reading them, and launches the heaviest
query tiles first. IEEE fp32 FMAs, no tensor cores.

Bound on an H100: at prefill lengths the two products (4 * hd flops per
attended (query, key) pair) against 67 TFLOP/s fp32 outside the tensor
cores; at short lengths the bytes of q, k, v and the output. Device time
on an H100 80GB HBM3 at 700 W (profiler, ``tools/attention_ab.py``):
qwen3-0.6b's b = 8, S = 512 round 0.4255 ms (30 % of its 0.1285 ms
bound; SDPA 0.99 ms; the previous kernel 1.7530), recurrentgemma-2b's
MQA (10 heads over one of 256) 0.5765 ms (SDPA 0.96; before 2.5283).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention import NEG, _check_head_dim


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The masked softmax of ``repro.kernels.ref.flash_attention_ref``."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,hd) float32; k/v (B,T,KV,hd) float32 -> (B,S,H,hd), row i
    having attended positions j < T with j <= i if ``causal`` and
    i - j < ``window`` if one is given. Every row must attend at least
    one position (the kernel writes zeros for a row that attends none;
    the reference would average every position).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise; ``launches``
    counts the kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _build.check_dense_args("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    _check_head_dim("flash_attention", hd)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if T == 0:
        raise ValueError("flash_attention: no key positions to attend")
    fn = _build.load("flash_attention")
    rc = fn(q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(), B, S,
            T, H, KV, hd, int(causal), -1 if window is None else int(window),
            float(scale), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
