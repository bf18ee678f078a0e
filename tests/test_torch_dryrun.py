"""The port's roofline and meta-device dry-run
(``repro_torch.launch.roofline``, ``launch.dryrun``) against the
reference's.

The analytic workload model is pure Python on both sides and must agree
exactly for every assigned arch and input shape. The dry-run's
``arg_bytes`` must equal a count made with the reference's own rules
(``param_pspec``, ``cache_pspec``, ``input_shardings``) over its abstract
params, optimizer state, cache and inputs on both production meshes,
built as ``jax.sharding.AbstractMesh``es. The meta sweep runs the reduced
configs' cases and one full config per shape kind, each ``ok`` or the
reference's documented skip (as tests/test_sharding_dryrun.py).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.common.tree import flatten_with_paths as jax_flatten
from repro.config import INPUT_SHAPES as JAX_SHAPES
from repro.config import get_config as jax_get_config
from repro.launch import roofline as ref_roofline
from repro.launch import sharding as ref_sharding
from repro.models import build_model as jax_build_model
from repro_torch.config import INPUT_SHAPES, get_config, get_reduced_config
from repro_torch.config.base import InputShape
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     make_tp_mesh)
from repro_torch.serving.bcedge import tp_collective_ms_per_token

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def test_input_shapes_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_workload_cost_equals_the_references(arch):
    """flops, hbm_bytes, model_flops and param_bytes, exactly, for every
    input shape and both dtypes; the roofline terms on the H100's
    data-sheet constants."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for dtype_bytes in (2, 4):
            got = roofline.workload_cost(cfg, shape, dtype_bytes)
            want = ref_roofline.workload_cost(jcfg, JAX_SHAPES[name],
                                              dtype_bytes)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
        t = got.terms(256, 1e9)
        assert t["compute_s"] == got.flops / (256 * 989e12)
        assert t["memory_s"] == got.hbm_bytes / (256 * 3.35e12)
        assert t["collective_s"] == 1e9 / 450e9


def _nbytes(leaf, spec, shape):
    n = leaf.dtype.itemsize
    for i, dim in enumerate(leaf.shape):
        ax = spec[i] if i < len(spec) else None
        k = 1
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            k *= shape[a]
        n *= -(-dim // k)
    return n


@functools.lru_cache(maxsize=4)
def _ref_params(arch, train):
    """The reference's abstract params, flattened: float32 to train,
    bfloat16 to serve (its dry-run's dtypes)."""
    model = jax_build_model(jax_get_config(arch), remat=False)
    return jax_flatten(model.abstract_params(
        jnp.float32 if train else jnp.bfloat16))


def _ref_arg_bytes(arch, name, multi_pod, mode):
    """One device's argument bytes from the reference's rules over its
    abstract trees, the way its dry-run builds a case."""
    shape_m, axes = MESHES[multi_pod]
    mesh = AbstractMesh(shape_m, axes)
    sizes = dict(mesh.shape)
    cfg, shape = jax_get_config(arch), JAX_SHAPES[name]
    train = shape.kind == "train"
    model = jax_build_model(cfg, remat=train)
    p_mode = "2d" if mode in ("2d", "decode2d") else "tp"
    total = 0
    for path, leaf in _ref_params(arch, train):
        spec = tuple(ref_sharding.param_pspec(path, leaf, p_mode,
                                              sizes.get("data", 1)))
        total += _nbytes(leaf, spec, sizes) * (3 if train else 1)
    if train:
        total += 4  # the optimizer's int32 step, replicated
    inputs = model.input_specs(shape, jnp.bfloat16)
    for key, sh in ref_sharding.input_shardings(mesh, cfg, inputs,
                                                mode).items():
        total += _nbytes(inputs[key], tuple(sh.spec), sizes)
    if shape.kind == "decode":
        cache = model.cache_spec(shape.global_batch, shape.seq_len,
                                 jnp.bfloat16)
        specs = dict(jax_flatten(ref_sharding.cache_shardings(
            mesh, cfg, cache, shape.global_batch, mode)))
        for path, leaf in jax_flatten(cache):
            total += _nbytes(leaf, tuple(specs[path].spec), sizes)
    return total


@pytest.mark.parametrize("arch", ASSIGNED)
def test_arg_bytes_equal_a_count_from_the_reference_rules(arch):
    """Every shape on both production meshes, in the CLI's ``auto``
    layout; the documented skip on both sides."""
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for name in INPUT_SHAPES:
            mode = dryrun.resolve_mode(arch, name, "auto")
            case = dryrun.build_case(arch, name, mesh, mode)
            if case is None:
                assert not jax_build_model(jax_get_config(
                    arch)).supports_shape(JAX_SHAPES[name])
                continue
            assert case[1] == _ref_arg_bytes(arch, name, multi_pod, mode), \
                (name, multi_pod, mode)


REDUCED_SHAPES = {k: dataclasses.replace(v, seq_len=128, global_batch=4)
                  for k, v in INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_meta_sweep_reduced_configs(arch, tmp_path):
    """Each reduced config's four cases at 128 tokens and batch 4, on the
    2x2 debug mesh and the 16x16 mesh: ``ok`` (the step ran on ``meta``)
    or the documented skip, with the reference's keys."""
    cfg = get_reduced_config(arch)
    for mesh in (make_debug_mesh(2, 2), make_production_mesh()):
        for name, shape in REDUCED_SHAPES.items():
            res = dryrun.run_case(arch, name, False, str(tmp_path), False,
                                  "tp", cfg=cfg, shape=shape, mesh=mesh)
            if name == "long_500k" and not cfg.subquadratic:
                assert res["status"] == "skipped", res
                continue
            assert res["status"] == "ok", res.get("traceback")
            for key in ("bytes_per_device", "arg_bytes", "collectives",
                        "analytic", "roofline", "dominant",
                        "useful_flops_ratio", "notes"):
                assert key in res
            assert res["bytes_per_device"] > 0
            assert all(v >= 0 for v in res["roofline"].values())
            assert res["dominant"].endswith("_s")
    assert len(os.listdir(tmp_path)) >= 4


@pytest.mark.parametrize("arch,name", [
    ("qwen3-0.6b", "train_4k"), ("arctic-480b", "prefill_32k"),
    ("rwkv6-3b", "long_500k"), ("qwen3-0.6b", "long_500k")])
def test_meta_sweep_full_configs(arch, name, tmp_path):
    """One published config per shape kind at its global shape on the
    2x16x16 mesh (through the CLI): a training step with Adam, an MoE
    prefill, a 512k decode of a subquadratic arch; and the documented
    skip. Nothing is written outside ``--out-dir``."""
    dryrun.main(["--arch", arch, "--shape", name, "--multi-pod",
                 "--out-dir", str(tmp_path)])
    (f,) = os.listdir(tmp_path)
    assert f == f"{arch}_{name}_2x16x16.json"
    with open(tmp_path / f) as fh:
        res = json.load(fh)
    want = "skipped" if arch == "qwen3-0.6b" and name == "long_500k" \
        else "ok"
    assert res["status"] == want, res.get("traceback")


def test_out_dir_never_the_references(tmp_path):
    with pytest.raises(SystemExit, match="reference"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                     "--out-dir", str(tmp_path / "experiments" / "dryrun")])
    assert dryrun.OUT_DIR == os.path.join("experiments", "dryrun_torch")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "chatglm3-6b", "yi-34b"])
def test_decode_collectives_agree_with_the_guards_surcharge(arch):
    """At data = 1, one decode token's all-reduces counted by
    ``collective_bytes`` at the port's fp32 payload are
    ``tp_collective_ms_per_token`` times the link bandwidth."""
    cfg = get_config(arch)
    one = InputShape("one", 32, 1, "decode")
    for tp in (1, 2, 4, 8):
        mesh = make_tp_mesh(tp, ["cpu"] * tp)
        # a decode step under "tp" moves no weights: the params' bytes
        # are not read
        got = roofline.collective_bytes(
            cfg, one, mesh, "tp", dtype_bytes=4,
            param_bytes_per_chip=0.0)["total_bytes"]
        assert got == pytest.approx(tp_collective_ms_per_token(cfg, tp)
                                    / 1000 * roofline.LINK_BW, rel=1e-12)


def test_collective_count_modes():
    """The counted terms by layout: a training step's backward doubles
    the activations' all-reduces and adds the gradient's over the batch
    axes (a reduce-scatter in 2d); 2d and decode2d gather the weights
    over data; decode2d keeps the whole batch on every chip."""
    cfg = get_config("qwen3-0.6b")
    mesh = make_production_mesh()
    ring = 2 * 15 / 16
    train = INPUT_SHAPES["train_4k"]
    act = (256 // 16) * 4096 * cfg.d_model * 2
    got = roofline.collective_bytes(cfg, train, mesh, "tp",
                                    param_bytes_per_chip=1e6)
    assert got["all-reduce_bytes"] == pytest.approx(
        2 * cfg.n_layers * 2 * ring * act + ring * 1e6)
    got = roofline.collective_bytes(cfg, train, mesh, "2d",
                                    param_bytes_per_chip=1e6)
    assert got["reduce-scatter_bytes"] == pytest.approx(ring * 1e6 / 2)
    assert got["all-gather_bytes"] == pytest.approx(15 / 16 * 1e6)
    dec = INPUT_SHAPES["decode_32k"]
    a = roofline.collective_bytes(cfg, dec, mesh, "tp", 2,
                                  param_bytes_per_chip=1e6)
    b = roofline.collective_bytes(cfg, dec, mesh, "decode2d", 2,
                                  param_bytes_per_chip=1e6)
    assert b["all-reduce_bytes"] == pytest.approx(16 * a["all-reduce_bytes"])
    assert np.isclose(a["total_bytes"], a["all-reduce_bytes"])
    assert jax.__version__  # the reference side ran under this jax
