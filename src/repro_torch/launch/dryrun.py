"""Launch-scale dry-run on the ``meta`` device: the port of
``repro.launch.dryrun``.

For every (arch x input shape x mesh) case, on the abstract 16x16
``(data, model)`` mesh or the 2x16x16 ``(pod, data, model)`` one
(``launch.mesh.make_production_mesh``):

* run the case's step on ``meta`` tensors at the GLOBAL shapes: the loss,
  its backward and the port's Adam update for ``train``; ``prefill`` for
  ``prefill``; ``decode_step`` over a ``seq_len``-long cache for
  ``decode``. Under ``kernels._build.shapes_only`` every kernel wrapper
  returns its output's shape on ``meta``, so this proves the port's model composes at the shape
  while allocating nothing;
* count the bytes per device of its arguments (params, Adam moments, the
  cache, the inputs) from the launch rules (``launch.sharding``);
* count its collective bytes per chip (``roofline.collective_bytes``) and
  the three roofline terms on the H100's data-sheet figures.

The reference forces 512 host devices and lowers and compiles each case
with XLA under GSPMD. The port executes no partition at this scale: one
process in eager PyTorch has no counterpart of GSPMD's partitioner, so
the launch rules here price memory and collectives, and the port's
executed tensor parallelism is the serving engine's head-split layout
(``engine_cache_pspec``, ``models.tp``). The result JSON carries the
reference's keys where they have a counterpart; XLA's ``lower_s``,
``compile_s``, ``cost_flops_raw``, ``temp_bytes`` and ``output_bytes`` are
left out (``notes`` says so) and ``bytes_per_device`` is ``arg_bytes``.
``long_500k`` on a full-attention arch is the reference's documented
skip.

This is the one entry point of the port that does not default to the GPU:
its only device is ``meta``, as the reference's dry-run needs no TPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape prefill_32k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results go to ``experiments/dryrun_torch/`` (``--out-dir``), never to the
reference's ``experiments/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.config import INPUT_SHAPES, get_config
from repro_torch.kernels import _build
from repro_torch.launch import roofline, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.train.optimizer import adam, apply_updates

SERVE_DTYPE = torch.bfloat16
TRAIN_DTYPE = torch.float32
OUT_DIR = os.path.join("experiments", "dryrun_torch")
NOTES = ("meta-device run of the port's step at global shapes; arg_bytes "
         "counted from the launch sharding rules; collective bytes counted "
         "(roofline.collective_bytes), not parsed; XLA's lower_s, "
         "compile_s, cost_flops_raw, temp_bytes and output_bytes have no "
         "counterpart and are omitted")


def resolve_mode(arch: str, shape_name: str, sharding_mode: str) -> str:
    """``auto``: ``decode2d`` for the decode of a model whose bf16 weights
    split 16 ways exceed 4 GiB, else ``tp`` (reference ``:128-140``)."""
    if sharding_mode != "auto":
        return sharding_mode
    w_gib_tp = get_config(arch).param_count_estimate() * 2 / 16 / 2 ** 30
    return ("decode2d" if INPUT_SHAPES[shape_name].kind == "decode"
            and w_gib_tp > 4.0 else "tp")


def build_case(arch: str, shape_name: str, mesh, sharding_mode: str = "tp",
               cfg=None, shape=None):
    """``(step, arg_bytes, param_bytes_tp)`` for one case, or None for the
    documented skip. ``step()`` runs the case on ``meta``; ``arg_bytes``
    is what one device holds of its arguments; ``param_bytes_tp`` is one
    device's params split over ``model`` alone (the gradient and weight
    collectives' payload). ``cfg`` and ``shape`` replace the arch's
    published config and the named shape (tests run reduced ones)."""
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    train = shape.kind == "train"
    model = build_model(cfg, remat=train)
    if shape.name == "long_500k" and not model.supports_shape(shape):
        return None
    dtype = TRAIN_DTYPE if train else SERVE_DTYPE
    params = model.abstract_params(dtype)
    p_mode = "2d" if sharding_mode in ("2d", "decode2d") else "tp"
    p_specs = sharding.param_shardings(mesh, params, mode=p_mode)
    inputs = model.input_specs(shape, SERVE_DTYPE)
    in_specs = sharding.input_shardings(mesh, cfg, inputs, mode=sharding_mode)
    per_device = sharding.bytes_per_device
    arg_bytes = per_device(params, p_specs, mesh) \
        + per_device(inputs, in_specs, mesh)
    param_tp = per_device(params, sharding.param_shardings(mesh, params),
                          mesh)

    if train:
        opt = adam(1e-4)
        state = opt.init(params)
        # mu and nu split as the params; the step is a replicated scalar
        arg_bytes += 2 * per_device(state.mu, p_specs, mesh) \
            + state.step.element_size()

        def step():
            for p in tree_leaves(params):
                p.requires_grad_(True)
            model.loss(params, inputs).backward()
            grads = tree_map(lambda p: p.grad, params)
            with torch.no_grad():
                updates, _ = opt.update(grads, state, params)
                apply_updates(params, updates)
        return step, arg_bytes, param_tp

    if shape.kind == "prefill":
        return (lambda: model.prefill(params, inputs)), arg_bytes, param_tp

    cache = model.cache_spec(shape.global_batch, shape.seq_len, SERVE_DTYPE)
    c_specs = sharding.cache_shardings(mesh, cfg, cache, shape.global_batch,
                                       mode=sharding_mode)
    arg_bytes += per_device(cache, c_specs, mesh)
    return (lambda: model.decode_step(params, cache, inputs)), arg_bytes, \
        param_tp


def run_case(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True,
             sharding_mode: str = "tp", cfg=None, shape=None,
             mesh=None) -> Dict:
    """One case, its result written to ``out_dir`` (if given) as the
    reference's JSON. ``cfg``, ``shape`` and ``mesh`` replace the arch's
    config, the named shape and the production mesh."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    chips = mesh.size
    sharding_mode = resolve_mode(arch, shape_name, sharding_mode)
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "sharding": sharding_mode}
    try:
        case = build_case(arch, shape_name, mesh, sharding_mode, cfg, shape)
        if case is None:
            result["status"] = "skipped"
            result["reason"] = ("full-attention arch at 512k decode "
                                "(docs/ARCHITECTURE.md §4)")
            _emit(result, out_dir, verbose)
            return result
        step, arg_bytes, param_tp = case
        cfg = cfg or get_config(arch)
        shape = shape or INPUT_SHAPES[shape_name]
        t0 = time.perf_counter()
        with _build.shapes_only():
            step()
        run_s = time.perf_counter() - t0
        colls = roofline.collective_bytes(
            cfg, shape, mesh, sharding_mode, dtype_bytes=2,
            param_bytes_per_chip=param_tp)
        wl = roofline.workload_cost(cfg, shape)
        terms = wl.terms(chips, colls["total_bytes"])
        dominant = max(("compute_s", "memory_s", "collective_s"),
                       key=lambda k: terms[k])
        result.update({
            "status": "ok",
            "run_s": round(run_s, 2),
            "bytes_per_device": int(arg_bytes),
            "arg_bytes": int(arg_bytes),
            "collectives": colls,
            "analytic": {
                "flops": wl.flops, "hbm_bytes": wl.hbm_bytes,
                "model_flops": wl.model_flops,
                "param_bytes": wl.param_bytes,
            },
            "roofline": {k: terms[k] for k in
                         ("compute_s", "memory_s", "collective_s")},
            "dominant": dominant,
            "useful_flops_ratio": (wl.model_flops / wl.flops
                                   if wl.flops else 0.0),
            "notes": NOTES,
        })
    except Exception as e:  # noqa: BLE001 - a failure here is a finding
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    _emit(result, out_dir, verbose)
    return result


def _emit(result: Dict, out_dir: Optional[str], verbose: bool) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir,
            f"{result['arch']}_{result['shape']}_{result['mesh']}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1, default=str)
    if not verbose:
        return
    head = (f"[dryrun] {result['arch']:28s} {result['shape']:12s} "
            f"{result['mesh']:8s}")
    if result["status"] == "ok":
        r = result["roofline"]
        print(f"{head} OK "
              f"mem/dev={result['bytes_per_device'] / 2 ** 30:.2f}GiB "
              f"compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms "
              f"coll={r['collective_s'] * 1e3:.2f}ms "
              f"dom={result['dominant'].split('_')[0]} "
              f"(meta run {result['run_s']:.1f}s)", flush=True)
    elif result["status"] == "skipped":
        print(f"{head} SKIP ({result['reason']})", flush=True)
    else:
        print(f"{head} ERROR {result['error'][:160]}", flush=True)


def _check_out_dir(out_dir: str) -> str:
    """The reference's artifacts live in ``experiments/dryrun/`` and its
    tests read them: the port writes anywhere else."""
    parts = os.path.normpath(os.path.abspath(out_dir)).split(os.sep)
    if parts[-2:] == ["experiments", "dryrun"]:
        raise SystemExit(f"--out-dir {out_dir}: experiments/dryrun/ holds "
                         "the reference's dry-run; use another directory")
    return out_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x shapes on this mesh")
    ap.add_argument("--sharding", default="auto",
                    choices=["auto", "tp", "2d", "decode2d"])
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    out_dir = _check_out_dir(args.out_dir)

    from repro_torch.configs import ASSIGNED

    if args.all:
        archs, shapes = ASSIGNED, list(INPUT_SHAPES)
    else:
        archs = [args.arch] if args.arch else ASSIGNED
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    t0 = time.perf_counter()
    failures = 0
    for arch in archs:
        for shape in shapes:
            res = run_case(arch, shape, args.multi_pod, out_dir,
                           sharding_mode=args.sharding)
            failures += res["status"] == "error"
    print(f"[dryrun] {len(archs) * len(shapes)} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run case(s) failed")


if __name__ == "__main__":
    main()
