"""The RWKV-6 WKV recurrence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/rwkv6_scan.py::rwkv6_scan`` (Pallas, TPU). Per
(sequence, head), with a ``(hd, hd)`` state carried through time::

    out_t = r_t · (S + u ∘ k_t v_tᵀ)
    S'    = w_t ∘ S + k_t v_tᵀ            (decay per key channel)

``time_mix_seq`` runs it on every RWKV layer's sequence form (round
prefill and each chunk of a chunked prefill). The Pallas kernel padded S
to its chunk with ``w = 1``; the kernel (``csrc/rwkv6_scan.cu``) runs one
thread block per (sequence, head), thread j holding column j of the state
in registers, and steps through exactly S steps. Head sizes up to 128.

Bound on an H100: bytes (about 20 * hd per (b, t, head)) just ahead of
operations (5 * hd^2 + 5 * hd flops) at hd 64.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: largest head size the kernel holds in registers
MAX_HEAD = 128


def wkv_step(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, the reference's ``_wkv_step``: state (B,H,hd,hd); r, k,
    v, w (B,H,hd); u (H,hd). Returns (new state, out (B,H,hd))."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    return w[..., :, None] * state + kv, out


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop over time of ``repro.kernels.ref.rwkv6_scan_ref`` (and of
    the reference's ``time_mix_seq``)."""
    outs = []
    for t in range(r.shape[1]):
        state, out = wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(out)
    if not outs:
        return r.new_empty(r.shape), state.clone()
    return torch.stack(outs, 1), state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,S,H,hd) float32; u (H,hd); state (B,H,hd,hd) float32
    -> (out (B,S,H,hd), final state (B,H,hd,hd)).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise; ``launches`` counts
    the kernel launches."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no kernel for {r.device}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be (B,S,H,hd), got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if not 1 <= hd <= MAX_HEAD:
        raise ValueError(f"rwkv6_scan: head size {hd}; the kernel holds "
                         f"1..{MAX_HEAD}")
    seq = (B, S, H, hd)
    _build.check_scan_args(
        "rwkv6_scan", {"r": r, "k": k, "v": v, "w": w, "u": u,
                       "state": state},
        {"r": seq, "k": seq, "v": seq, "w": seq, "u": (H, hd),
         "state": (B, H, hd, hd)})
    out = torch.empty_like(r)
    s_final = torch.empty_like(state)
    if B == 0 or H == 0:
        return out, s_final
    fn = _build.load("rwkv6_scan")
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), out.data_ptr(),
            s_final.data_ptr(), B, S, H, hd, r.device.index,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {rc}")
    rwkv6_scan.launches += 1
    return out, s_final


rwkv6_scan.launches = 0
