"""The RG-LRU diagonal recurrence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/rglru_scan.py::rglru_scan`` (Pallas, TPU):
``h_t = a_t * h_{t-1} + x_t`` over ``(B, S, W)`` from ``h0 (B, W)``,
returning every ``h_t`` and the final state. ``rglru_seq`` runs it on
every RG-LRU layer's sequence form (round prefill and each chunk of a
chunked prefill). The Pallas kernel padded S and W to its blocks with
``a = 1``, ``x = 0``; the kernel (``csrc/rglru_scan.cu``) runs one thread
per (sequence, channel), steps through exactly S steps and reads nothing
past S or W.

Bound on an H100: bytes, 12 per (b, t, w) (a and x read, h written).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build


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


def rglru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x (B,S,W) float32; h0 (B,W) float32 -> (hs (B,S,W), h_final
    (B,W)).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise; ``launches`` counts
    the kernel launches."""
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
    rc = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            h_final.data_ptr(), B, S, W, a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc}")
    rglru_scan.launches += 1
    return hs, h_final


rglru_scan.launches = 0
