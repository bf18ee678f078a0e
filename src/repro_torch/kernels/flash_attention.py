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

Training differentiates it (:class:`FlashAttention`): the forward is the
kernel, the backward :func:`flash_attention_backward`, torch ops over
512 query rows at a time that recompute the probabilities from the saved
q, k and the kernel's output (the reference differentiates its jnp
attention with XLA, outside any Pallas kernel).

Bound on an H100: at prefill lengths the two products (4 * hd flops per
attended (query, key) pair) against 67 TFLOP/s fp32 outside the tensor
cores; at short lengths the bytes of q, k, v and the output. Device time
on an H100 80GB HBM3 at 700 W (profiler, ``tools/attention_ab.py``):
qwen3-0.6b's b = 8, S = 512 round 0.4255 ms (30 % of its 0.1285 ms
bound; SDPA 0.99 ms; the previous kernel 1.7530), recurrentgemma-2b's
MQA (10 heads over one of 256) 0.5765 ms (SDPA 0.96; before 2.5283).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attention import NEG, _check_head_dim


BWD_ROWS = 512


def _mask(r0: int, r1: int, T: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(r1 - r0, T) bool: may query row i (r0 <= i < r1) attend slot j."""
    qpos = torch.arange(r0, r1, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((r1 - r0, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The masked softmax of ``repro.kernels.ref.flash_attention_ref``."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    scores = torch.where(_mask(0, S, T, causal, window, q.device), scores,
                         NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, scale: float,
                             causal: bool = True,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of ``out = flash_attention(q, k, v)`` given ``dout``:
    per block of ``BWD_ROWS`` query rows, P = softmax(mask(scale QK^T)),
    dV += P^T dO, dS = P (dO V^T - rowsum(dO * O)), dQ = scale dS K,
    dK += scale dS^T Q, each KV head summing its G query heads. Memory
    holds one block's (B, H, BWD_ROWS, T) probabilities at a time."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    og = out.reshape(B, S, KV, G, hd).float()
    dog = dout.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, S, BWD_ROWS):
        r1 = min(S, r0 + BWD_ROWS)
        qb, dob = qg[:, r0:r1], dog[:, r0:r1]
        scores = torch.einsum("bskgh,btkh->bkgst", qb, kf) * scale
        probs = torch.softmax(torch.where(
            _mask(r0, r1, T, causal, window, q.device), scores, NEG), -1)
        dv += torch.einsum("bkgst,bskgh->btkh", probs, dob)
        dp = torch.einsum("bskgh,btkh->bkgst", dob, vf)
        delta = (dob * og[:, r0:r1]).sum(-1).permute(0, 2, 3, 1)
        ds = probs * (dp - delta[..., None])
        dq[:, r0:r1] = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
        dk += torch.einsum("bkgst,bskgh->btkh", ds, qb) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, scale: float,
                           causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors (on the current
    stream, no synchronisation; ``flash_attention.launches`` counts its
    launches), the plain version on CPU tensors. Raises ``RuntimeError``
    for inputs that require grad under grad mode (its output would carry
    no gradient): :func:`flash_attention` differentiates it."""
    _build.check_no_grad("flash_attention", q, k, v)
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


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        out = flash_attention_launch(q, k, v, scale=scale, causal=causal,
                                     window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, dout, **ctx.args),
                None, None, None)


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
    counts the kernel launches. Under grad mode with an input that
    requires grad the call goes through :class:`FlashAttention`, so the
    output carries the gradient on both devices."""
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale, causal, window)
    return flash_attention_launch(q, k, v, scale=scale, causal=causal,
                                  window=window)


flash_attention.launches = 0
