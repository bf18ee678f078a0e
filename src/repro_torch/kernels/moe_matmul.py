"""The grouped per-expert GEMM: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/moe_matmul.py::moe_matmul`` (Pallas, TPU):
``out[e] = x[e] @ w[e]`` for ``x (E, C, d)`` and ``w (E, d, f)``, f32
accumulation. ``models.moe.moe_apply`` runs its three expert products
(gate, up, down) through it, on every MoE layer of every forward. The
Pallas kernel padded C, d and f to its blocks; the kernel
(``csrc/moe_matmul.cu``) guards its edges and reads nothing past them.

Bound on an H100: bytes on the serving path (C = 8 at decode, at most 16
in a prefill chunk: every weight read once, 2 * C flops per 4 bytes);
operations in a round's one-shot prefill (C = 80 at arctic-480b).

Training differentiates it (:class:`MoeMatmul`) with the same kernel
twice: dx = dy @ w^T and dw = x^T @ dy, per expert, over contiguous
transposes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def moe_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``repro.kernels.ref.moe_matmul_ref``: ``einsum("ecd,edf->ecf")`` in
    float32, cast back to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def _check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """float32, contiguous, one device, x (E,C,d) and w (E,d,f) with E at
    most 65535 (the grid's z axis), f a multiple of 4 and w 16-byte
    aligned (the kernel reads w as float4). Raises ``ValueError``
    otherwise, on every device, so the CPU refuses what the card
    would."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_matmul: x (E,C,d) and w (E,d,f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_matmul: x {tuple(x.shape)} does not match "
                         f"w {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise ValueError(f"moe_matmul: {name} must be float32 (got "
                             f"{t.dtype}); other types are still to port "
                             "(ROADMAP.md)")
        if not t.is_contiguous():
            raise ValueError(f"moe_matmul: {name} must be contiguous")
    if w.device != x.device:
        raise ValueError(f"moe_matmul: w on {w.device}, x on {x.device}")
    if w.shape[2] % 4 or w.data_ptr() % 16:
        raise ValueError(f"moe_matmul: f ({w.shape[2]}) must be a multiple "
                         "of 4 and w 16-byte aligned")
    if x.shape[0] > 65535 or max(x.shape[1:]) >= 2 ** 31 \
            or w.shape[2] >= 2 ** 31:
        raise ValueError(f"moe_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} exceed the kernel's grid")


def moe_matmul_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors (on the current
    stream, no synchronisation; ``moe_matmul.launches`` counts its
    launches), the plain version on CPU tensors. Raises ``RuntimeError``
    for inputs that require grad under grad mode: :func:`moe_matmul`
    differentiates it."""
    _build.check_no_grad("moe_matmul", x, w)
    _check_args(x, w)
    if x.device.type == "cpu":
        return moe_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_matmul: no kernel for {x.device}")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.load("moe_matmul")
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_matmul launch failed: CUDA error {rc}")
    moe_matmul.launches += 1
    return out


class MoeMatmul(torch.autograd.Function):
    """The kernel's forward; its backward is the kernel twice."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_matmul_launch(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = moe_matmul_launch(dy, w.transpose(1, 2).contiguous()) \
            if ctx.needs_input_grad[0] else None
        dw = moe_matmul_launch(x.transpose(1, 2).contiguous(), dy) \
            if ctx.needs_input_grad[1] else None
        return dx, dw


def moe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E,C,d) float32 @ w (E,d,f) float32 -> (E,C,f), contiguous.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise; ``launches`` counts
    the kernel launches. Under grad mode with an input that requires grad
    the call goes through :class:`MoeMatmul`, on both devices."""
    if _build.needs_grad(x, w):
        return MoeMatmul.apply(x, w)
    return moe_matmul_launch(x, w)


moe_matmul.launches = 0
