"""The RG-LRU diagonal recurrence: the CUDA kernel's wrapper, its launch
plan and its plain PyTorch version.

Replaces ``repro/kernels/rglru_scan.py::rglru_scan`` (Pallas, TPU):
``h_t = a_t * h_{t-1} + x_t`` over ``(B, S, W)`` from ``h0 (B, W)``,
returning every ``h_t`` and the final state. ``rglru_seq`` runs it on
every RG-LRU layer's sequence form (round prefill and each chunk of a
chunked prefill). The Pallas kernel padded S and W to its blocks with
``a = 1``, ``x = 0``. The kernel (``csrc/rglru_scan.cu``) gives a warp 32
channels and streams a and x through a 32-step ``cp.async`` ring in
shared memory. Where the channels alone cannot keep enough bytes in
flight (:func:`rglru_plan`, e.g. one sequence at W = 2560) it splits S
into chunks: pass 1 composes each chunk into a summary ``(prod a, h from
0)``, pass 2 folds the earlier summaries into its chunk's start state and
runs the chunk's exact recurrence. One pass repeats the plain loop bit for
bit; two passes round only the chunks' start states differently. Nothing
past S or W is read.

Training differentiates it (:class:`RGLRUScan`) with the same kernel run
over reversed time: the adjoint of h_t = a_t h_{t-1} + x_t is
lam_t = g_t + a_{t+1} lam_{t+1}, from lam at the end = g + the final
state's gradient, itself a scan of this form (:func:`rglru_scan_backward`).
So a backward is one more launch, exact.

Bound on an H100: bytes, 12 per (b, t, w) (a and x read, h written).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import sm_count

#: channels per block of the kernel: one warp, a lane per channel
RGLRU_CHANNELS = 32
#: (sequence, channel) pairs per SM at and above which one pass keeps
#: enough bytes in flight (the kernel's 32-step ring: 256 bytes each)
RGLRU_PAIRS_PER_SM = 128
#: most time chunks of the two-pass form, and the shortest chunk
RGLRU_MAX_CHUNKS = 16
RGLRU_MIN_CHUNK = 16


def rglru_plan(B: int, S: int, W: int, n_sm: int) -> Tuple[int, int, int]:
    """(channels per block, time chunks C, chunk length L) of the card's
    kernel over ``(B, S, W)`` on ``n_sm`` SMs. A pure function of shapes.

    One chunk (one pass) where ``B * W >= RGLRU_PAIRS_PER_SM * n_sm``
    (B = 8 at W = 2560 on 132 SMs: 20,480 of 16,896); else as many chunks
    as allowed, at most 16 and at least 16 steps each (B = 1 at W = 2560:
    16 chunks of 32 of 512 steps). On an H100 at (1, 512, 2560) 16 chunks
    took 0.0143 ms, 7 0.0171 and one pass 0.0490; at (8, 512, 2560) one
    pass 0.0550 and 2 chunks 0.0645 (``tools/scan_sweep.py``). L = ceil(S
    / C) and C = ceil(S / L), so the last chunk may be short but none is
    empty."""
    C = 1
    if B * W < RGLRU_PAIRS_PER_SM * n_sm:
        C = max(1, min(RGLRU_MAX_CHUNKS, S // RGLRU_MIN_CHUNK))
    L = max(1, -(-S // C))
    return RGLRU_CHANNELS, max(1, -(-S // L)), L


def rglru_scan_plain(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop over time of ``repro.kernels.ref.rglru_scan_ref`` (and of
    the reference's ``rglru_seq``)."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    if not hs:
        return a.new_empty(a.shape), h0.clone()
    return torch.stack(hs, 1), h


def rglru_scan_launch(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward alone: the kernel on CUDA tensors (on the current
    stream, no synchronisation; ``rglru_scan.launches`` counts its
    launches), the plain version on CPU tensors. Raises ``RuntimeError``
    for inputs that require grad under grad mode: :func:`rglru_scan`
    differentiates it."""
    _build.check_no_grad("rglru_scan", a, x, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for {a.device}")
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a must be (B,S,W), got "
                         f"{tuple(a.shape)}")
    B, S, W = a.shape
    _build.check_scan_args("rglru_scan", {"a": a, "x": x, "h0": h0},
                           {"a": (B, S, W), "x": (B, S, W), "h0": (B, W)})
    hs = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    if B == 0 or W == 0:
        return hs, h_final
    fn = _build.load("rglru_scan")
    cb, C, L = rglru_plan(B, S, W, sm_count(a.device))
    # the chunks' summaries (prod a, then h from 0), two passes only
    summaries = torch.empty((2, B, C, W), dtype=a.dtype, device=a.device) \
        if C > 1 else None
    rc = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            h_final.data_ptr(),
            summaries.data_ptr() if summaries is not None else None,
            B, S, W, cb, C, L, a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc}")
    rglru_scan.launches += 1
    return hs, h_final


def rglru_scan_backward(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor,
                        g_hs: torch.Tensor, g_final: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, dx, dh0) of ``hs, h_final = rglru_scan(a, x, h0)`` given the
    gradients of both outputs, through one forward launch over reversed
    time: with A = (1, a_{S-1}, ..., a_1) and X = (g_{S-1}, ..., g_0)
    from the state g_final, step tau of the scan is lam_{S-1-tau}. Then
    dx = lam, da_t = lam_t h_{t-1} (h_{-1} = h0) and dh0 = a_0 lam_0."""
    B, S, W = a.shape
    rev_a = torch.cat([a.new_ones((B, 1, W)), a[:, 1:].flip(1)], dim=1)
    lam, _ = rglru_scan_launch(rev_a, g_hs.flip(1).contiguous(),
                               g_final.contiguous())
    lam = lam.flip(1)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    return lam * h_prev, lam, a[:, 0] * lam[:, 0]


class RGLRUScan(torch.autograd.Function):
    """The kernel's forward with :func:`rglru_scan_backward`."""

    @staticmethod
    def forward(ctx, a, x, h0):
        hs, h_final = rglru_scan_launch(a, x, h0)
        ctx.save_for_backward(a, h0, hs)
        return hs, h_final

    @staticmethod
    def backward(ctx, g_hs, g_final):
        return rglru_scan_backward(*ctx.saved_tensors, g_hs, g_final)


def rglru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x (B,S,W) float32; h0 (B,W) float32 -> (hs (B,S,W), h_final
    (B,W)).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise; ``launches`` counts
    the kernel launches. Under grad mode with an input that requires grad
    the call goes through :class:`RGLRUScan`, on both devices."""
    if _build.needs_grad(a, x, h0):
        return RGLRUScan.apply(a, x, h0)
    return rglru_scan_launch(a, x, h0)


rglru_scan.launches = 0
