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

KERNELS = ("paged_decode_attention", "paged_prefill_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: loaded C entry points, one per kernel for the process's lifetime
_FNS: Dict[str, Callable[..., int]] = {}
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
        raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every kernel in ``names`` (default: all) whose library is
    missing, one ``nvcc`` process per source, all started together.
    Returns name -> library path. Raises with the compiler's output on a
    failed build."""
    names = tuple(names) if names is not None else KERNELS
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


def load(name: str, n_ints: int) -> Callable[..., int]:
    """The C entry point ``<name>_f32`` of kernel ``name``, built first
    if needed. Its arguments: six device pointers (q, out, k_pool,
    v_pool, tables, per-sequence vector), ``n_ints`` ints, the float
    scale, the device index and the stream. It returns the launch's
    ``cudaError_t``."""
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            fn = getattr(lib, f"{name}_f32")
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return fn


def check_launch_args(name: str, q, k_pool, v_pool, block_tables,
                      per_seq) -> None:
    """Validate what a paged attention kernel takes: float32 q (B,T,H,hd)
    and pools (N,bs,KV,hd), int32 tables (B,nb) and per-sequence vector
    (B,), all contiguous and on one CUDA device; hd a multiple of 4 and
    H a multiple of KV. Raises ``ValueError`` otherwise."""
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"{name}: {what}")

    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "per-sequence": per_seq}
    for tname, t in tensors.items():
        need(t.device == q.device, f"{tname} on {t.device}, q on {q.device}")
        need(t.is_contiguous(), f"{tname} must be contiguous")
        need(t.data_ptr() % 16 == 0, f"{tname} must be 16-byte aligned")
    for tname in ("q", "k_pool", "v_pool"):
        need(tensors[tname].dtype == torch.float32,
             f"{tname} must be float32 (got {tensors[tname].dtype}); other "
             "types are still to port (ROADMAP.md)")
    for tname in ("block_tables", "per-sequence"):
        need(tensors[tname].dtype == torch.int32,
             f"{tname} must be int32 (got {tensors[tname].dtype})")
    need(q.dim() == 4 and k_pool.dim() == 4, "q and pools must be 4-D")
    B, _, H, hd = q.shape
    _, _, KV, hd_k = k_pool.shape
    need(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    need(hd_k == hd and hd % 4 == 0, f"head_dim {hd} vs {hd_k}, must be "
         "equal and a multiple of 4")
    need(KV >= 1 and H % KV == 0, f"{H} query heads over {KV} KV heads")
    need(block_tables.dim() == 2 and block_tables.shape[0] == B,
         f"block_tables {tuple(block_tables.shape)} for batch {B}")
    need(tuple(per_seq.shape) == (B,), f"per-sequence vector "
         f"{tuple(per_seq.shape)} for batch {B}")
