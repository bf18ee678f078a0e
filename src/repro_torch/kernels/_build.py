"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \
         csrc/<name>.cu

The library name carries a hash of every source in ``csrc/`` and of the
flags, so an edited kernel is rebuilt and a stale one is never loaded.
Builds happen at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); :func:`build` starts one ``nvcc``
per missing source, all together. No fast-math: ``expf`` accuracy is part
of the kernels' stated tolerance. A missing ``nvcc`` or a failed compile
raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (kernels -> repro_torch -> src -> checkout)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each kernel's C entry point ``<name>_f32``: the types of its leading
#: arguments (device pointers, then ints, then the attention kernels'
#: float scale); every entry point then takes the device index and the
#: stream, and returns the launch's ``cudaError_t``
KERNELS: Dict[str, tuple] = {
    # q, out, k_pool, v_pool, tables, seq_lens; B H KV hd N bs nb
    "paged_decode_attention": (_P,) * 6 + (_I,) * 7 + (_F,),
    # q, out, acc, m, l, k_pool, v_pool, tables, seq_lens;
    # B H KV hd N bs nb n_splits bps
    "paged_decode_attention_splitk": (_P,) * 9 + (_I,) * 9 + (_F,),
    # q, out, k_pool, v_pool, tables, pos; B T H KV hd N bs nb
    "paged_prefill_attention": (_P,) * 6 + (_I,) * 8 + (_F,),
    # q, out, k, v; B S T H KV hd causal window
    "flash_attention": (_P,) * 4 + (_I,) * 8 + (_F,),
    # q, out, acc, m, l, k, v, valid; B C H KV hd n_splits split_slots
    "decode_attention": (_P,) * 8 + (_I,) * 7 + (_F,),
    # a, x, h0, hs, h_final, summaries; B S W cb n_chunks chunk_len
    "rglru_scan": (_P,) * 6 + (_I,) * 6,
    # r, k, v, w, u, state, out, s_final; B S H hd jc R rows
    "rwkv6_scan": (_P,) * 8 + (_I,) * 7,
    # x, w, out; E C D F
    "moe_matmul": (_P,) * 3 + (_I,) * 4,
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: loaded C entry points, one per kernel for the process's lifetime
_FNS: Dict[str, Callable[..., int]] = {}
#: libraries built or loaded so far in this process (the engines mark a
#: step during which this grew, as the reference marks a compiling step)
n_loads = 0
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    /usr/local/cuda). Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from source at first use and need the CUDA "
        "toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every kernel in ``names`` (default: all) whose library is
    missing, one ``nvcc`` process per source, all started together.
    Returns name -> library path. Raises with the compiler's output on a
    failed build."""
    names = tuple(names) if names is not None else tuple(KERNELS)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        p = todo[n]
        p.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{out}")
            continue
        os.replace(tmp, p)  # atomic: a concurrent loader never sees half
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> Callable[..., int]:
    """The C entry point ``<name>_f32`` of kernel ``name``, built first
    if needed, with the argument types ``KERNELS[name]`` lists (the
    attention kernels end with the float scale) followed by the device
    index and the stream. It returns the launch's
    ``cudaError_t``."""
    global n_loads
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            n_loads += 1
            lib = ctypes.CDLL(str(build([name])[name]))
            fn = getattr(lib, f"{name}_f32")
            fn.argtypes = list(KERNELS[name]) + [_I, _P]
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return fn


def _check_common(name: str, q, k, v, others: Dict[str, tuple]) -> None:
    """What every attention kernel takes: float32 q (B,T,H,hd) and k/v of
    one 4-D shape with hd a multiple of 4 and H a multiple of KV; every
    tensor contiguous and on q's CUDA device; the float tensors 16-byte
    aligned. ``others`` maps a name to (tensor, required dtype)."""
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"{name}: {what}")

    floats = {"q": q, "k": k, "v": v}
    tensors = {**floats, **{n: t for n, (t, _) in others.items()}}
    for tname, t in tensors.items():
        need(t.device == q.device, f"{tname} on {t.device}, q on {q.device}")
        need(t.is_contiguous(), f"{tname} must be contiguous")
    for tname, t in floats.items():
        need(t.data_ptr() % 16 == 0, f"{tname} must be 16-byte aligned")
        need(t.dtype == torch.float32,
             f"{tname} must be float32 (got {t.dtype}); other types are "
             "still to port (ROADMAP.md)")
    for tname, (t, dtype) in others.items():
        need(t.dtype == dtype, f"{tname} must be {dtype} (got {t.dtype})")
    need(q.dim() == 4 and k.dim() == 4, "q and k/v must be 4-D")
    hd, KV, H = q.shape[3], k.shape[2], q.shape[2]
    need(v.shape == k.shape, "k and v shapes differ")
    need(k.shape[3] == hd and hd % 4 == 0, f"head_dim {hd} vs "
         f"{k.shape[3]}, must be equal and a multiple of 4")
    need(KV >= 1 and H % KV == 0, f"{H} query heads over {KV} KV heads")


def check_launch_args(name: str, q, k_pool, v_pool, block_tables,
                      per_seq) -> None:
    """Validate what a paged attention kernel takes: float32 q (B,T,H,hd)
    and pools (N,bs,KV,hd), int32 tables (B,nb) and per-sequence vector
    (B,), all contiguous and on one CUDA device; hd a multiple of 4 and
    H a multiple of KV. Raises ``ValueError`` otherwise."""
    _check_common(name, q, k_pool, v_pool,
                  {"block_tables": (block_tables, torch.int32),
                   "per-sequence": (per_seq, torch.int32)})
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables "
                         f"{tuple(block_tables.shape)} for batch {B}")
    if tuple(per_seq.shape) != (B,):
        raise ValueError(f"{name}: per-sequence vector "
                         f"{tuple(per_seq.shape)} for batch {B}")


def check_dense_args(name: str, q, k, v, valid=None) -> None:
    """Validate what a dense attention kernel takes: float32 q (B,S,H,hd)
    and k/v (B,T,KV,hd), and, for decode, a torch.bool ``valid`` (B,T),
    all contiguous and on one CUDA device; hd a multiple of 4 and H a
    multiple of KV. Raises ``ValueError`` otherwise."""
    others = {} if valid is None else {"valid": (valid, torch.bool)}
    _check_common(name, q, k, v, others)
    B, T = q.shape[0], k.shape[1]
    if k.shape[0] != B:
        raise ValueError(f"{name}: k/v batch {k.shape[0]}, q batch {B}")
    if valid is not None and tuple(valid.shape) != (B, T):
        raise ValueError(f"{name}: valid {tuple(valid.shape)} for k/v "
                         f"{tuple(k.shape)}")


def check_scan_args(name: str, tensors: Dict[str, torch.Tensor],
                    shapes: Dict[str, tuple]) -> None:
    """Validate what a recurrent scan kernel takes: every tensor float32,
    contiguous, on the first one's CUDA device and of the shape
    ``shapes`` gives it. Raises ``ValueError`` otherwise."""
    dev = next(iter(tensors.values())).device
    for tname, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {tname} on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {tname} must be float32 (got "
                             f"{t.dtype}); other types are still to port "
                             "(ROADMAP.md)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if tuple(t.shape) != tuple(shapes[tname]):
            raise ValueError(f"{name}: {tname} {tuple(t.shape)}, expected "
                             f"{tuple(shapes[tname])}")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd must see this call: grad mode is on and an input
    requires grad. A wrapper then goes through its
    ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Refuse a raw forward whose output autograd would need: a kernel's
    output carries no ``grad_fn``, so every weight upstream would get a
    zero gradient without an error. Raises ``RuntimeError``, on every
    device, so the CPU refuses what the card would."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad under grad mode, and the raw "
            f"forward has no backward; call {name}(), whose "
            "torch.autograd.Function carries the gradient")
