"""The RWKV-6 WKV recurrence: the CUDA kernel's wrapper, its launch plan
and its plain PyTorch version.

Replaces ``repro/kernels/rwkv6_scan.py::rwkv6_scan`` (Pallas, TPU). Per
(sequence, head), with a ``(hd, hd)`` state carried through time::

    out_t = r_t · (S + u ∘ k_t v_tᵀ)
    S'    = w_t ∘ S + k_t v_tᵀ            (decay per key channel)

``time_mix_seq`` runs it on every RWKV layer's sequence form (round
prefill and each chunk of a chunked prefill). The Pallas kernel padded S
to its chunk with ``w = 1``. The kernel (``csrc/rwkv6_scan.cu``) runs
parallel over the state and staged over time: one block per (column
group, head, sequence), ``R`` threads splitting the key rows of its
``JC`` value columns, each holding 4 x 4 state elements in registers
(:func:`rwkv6_plan`), r, k, w and v staged 32 steps at a time in shared
memory with ``cp.async``, and the R partials of each output summed once
per chunk. Each state element keeps the plain loop's update: a chunked
form over time would need products of w, which underflow fp32 at
rwkv6-3b's decays. Head sizes up to 128; nothing past S or hd is read.

Bound on an H100: bytes (about 20 * hd per (b, t, head)) just ahead of
operations (5 * hd^2 + 5 * hd flops) at hd 64.

Training differentiates it (:class:`RWKV6Scan`): the forward is the
kernel, the backward a reverse pass in torch ops, autograd of the plain
loop recomputed from the saved inputs (the reference differentiates its
``lax.scan``, outside Pallas). A backward kernel waits until a trace
shows this pass matters (ROADMAP.md, Queue B).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import sm_count

#: largest head size the kernel takes
MAX_HEAD = 128
#: the kernel's thread tile: key rows and value columns per thread
ROWS = COLS = 4
#: most threads in one of its blocks (JC / COLS * R)
MAX_THREADS = 256
#: its steps staged per chunk and chunk buffers, and the shared memory a
#: block may take (bytes)
CHUNK, STAGES, MAX_SMEM = 32, 3, 232448


def rwkv6_smem(jc: int, R: int) -> int:
    """Shared memory of one block of the kernel (bytes): STAGES chunk
    buffers of r, k, w (CHUNK x 4R rows) and v (CHUNK x jc), and CHUNK
    rows of the threads' partials of out (4 floats each, one float4 of
    pad a row)."""
    nt = jc // COLS * R
    return 4 * (STAGES * (3 * CHUNK * R * ROWS + CHUNK * jc)
                + CHUNK * COLS * (nt + 1))


def rwkv6_plan(B: int, H: int, hd: int, n_sm: int) -> Tuple[int, int, int]:
    """(columns per block JC, threads per 4 columns R, rows per thread
    ROWS) of the card's kernel over ``B`` sequences of ``H`` heads of
    ``hd`` on ``n_sm`` SMs. A pure function of shapes.

    Each thread holds ROWS = 4 key rows of COLS = 4 neighbouring value
    columns; R = ceil(hd / 4) threads cover the hd rows of a column group
    (the rows past hd hold zeros), so a block runs JC / 4 * R threads.
    JC is one of 64, 32, 16, 8 (at most max(8, hd), at most 256 threads,
    the shared memory within the card's): the narrowest whose blocks fit
    one wave of one block per SM, else the widest, since each block
    stages its head's r, k and w whole. At rwkv6-3b's B = 1 (40 heads of
    64) one wave of 80 blocks beat 160 blocks on 132 SMs (28 of which
    then hold two), and at B = 8 320 blocks of 64 columns beat 640 of 32
    (``tools/scan_sweep.py``; PERF.md has the times). So B = 1 takes (32,
    16, 4), 80 blocks of 128 threads, and B = 8 (64, 16, 4), 320 blocks
    of 256."""
    R = -(-hd // ROWS)
    widths = [jc for jc in (64, 32, 16, 8)
              if jc <= max(8, hd) and jc // COLS * R <= MAX_THREADS
              and rwkv6_smem(jc, R) <= MAX_SMEM]
    one_wave = [jc for jc in widths if B * H * -(-hd // jc) <= n_sm]
    return (one_wave[-1] if one_wave else widths[0]), R, ROWS


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


def rwkv6_scan_launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward alone: the kernel on CUDA tensors (on the current
    stream, no synchronisation; ``rwkv6_scan.launches`` counts its
    launches), the plain version on CPU tensors. Raises ``RuntimeError``
    for inputs that require grad under grad mode: :func:`rwkv6_scan`
    differentiates it."""
    _build.check_no_grad("rwkv6_scan", r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state)
    if _build.abstract(r):
        return torch.empty_like(r), torch.empty_like(state)
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
            s_final.data_ptr(), B, S, H, hd,
            *rwkv6_plan(B, H, hd, sm_count(r.device)), r.device.index,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {rc}")
    rwkv6_scan.launches += 1
    return out, s_final


def rwkv6_scan_backward(saved: Tuple[torch.Tensor, ...], d_out: torch.Tensor,
                        d_state: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, dstate) of ``rwkv6_scan(*saved)`` given the
    gradients of its two outputs: autograd of :func:`rwkv6_scan_plain`
    recomputed from the saved inputs, on their device (shapes only on
    ``meta`` under ``_build.shapes_only``)."""
    if _build.abstract(saved[0]):
        return tuple(torch.empty_like(t) for t in saved)
    ins = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        out, s_final = rwkv6_scan_plain(*ins)
        return torch.autograd.grad((out, s_final), ins, (d_out, d_state))


class RWKV6Scan(torch.autograd.Function):
    """The kernel's forward with :func:`rwkv6_scan_backward`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return rwkv6_scan_launch(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, d_out, d_state):
        return rwkv6_scan_backward(ctx.saved_tensors, d_out, d_state)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,S,H,hd) float32; u (H,hd); state (B,H,hd,hd) float32
    -> (out (B,S,H,hd), final state (B,H,hd,hd)).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise; ``launches`` counts
    the kernel launches. Under grad mode with an input that requires grad
    the call goes through :class:`RWKV6Scan`, on both devices."""
    if _build.needs_grad(r, k, v, w, u, state):
        return RWKV6Scan.apply(r, k, v, w, u, state)
    return rwkv6_scan_launch(r, k, v, w, u, state)


rwkv6_scan.launches = 0
