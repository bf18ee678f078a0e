"""The port's sharding rules and meshes (``repro_torch.launch.sharding``,
``launch.mesh``) against the reference's.

Every rule is pure Python on both sides, so the specs are compared leaf
for leaf over every reduced config's params and caches: the reference
stacks its layers (``units/<pos>/...`` with a leading ``n_units`` dim),
the port keeps one subtree per layer (``layers/<i>/...``), so the port's
spec is the reference's without that leading ``None``. The reference's
meshes are ``jax.sharding.AbstractMesh``es (no devices needed), the
port's its abstract ``meta`` meshes. Then the divisibility invariant of
``tests/test_sharding_specs.py``, the rule unit cases of
``tests/test_sharding_dryrun.py``, the meshes' errors and
``shard_tree``/``bytes_per_device``.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.common.tree import flatten_with_paths as jax_flatten
from repro.config import get_reduced_config as jax_reduced
from repro.launch import sharding as ref_sharding
from repro.models import build_model as jax_build_model
from repro_torch.common.tree import flatten_with_paths, tree_map_with_path
from repro_torch.config import get_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.configs import ASSIGNED
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (TPMesh, batch_axes, make_debug_mesh,
                                     make_production_mesh, make_tp_mesh)
from repro_torch.models import build_model
from repro_torch.models.transformer import make_cache

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _ref_path(path: str, cfg, cache: bool = False):
    """The reference's path for a port path, and whether its leaf carries
    the stacked unit dim."""
    parts = path.split("/")
    k = len(cfg.block_pattern)
    n_stacked = (cfg.n_layers // k) * k
    if cache or parts[0] == "layers":
        if not cache:
            parts = parts[1:]
        i, rest = int(parts[0]), parts[1:]
        if i < n_stacked:
            return "/".join(["units", str(i % k)] + rest), True
        return "/".join(["tail", str(i - n_stacked)] + rest), False
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(parts[:2] + parts[3:]), True
    return path, False


def _unstacked(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def _spec_map(tree, specs):
    """{path: spec} of a spec tree (its tuples are leaves), walked along
    the leaves of ``tree``."""
    out = {}
    tree_map_with_path(lambda path, leaf, spec: out.__setitem__(path, spec),
                       tree, specs)
    return out


def _pairs(cfg, port_tree, ref_tree, cache=False):
    ref = dict(jax_flatten(ref_tree))
    out = list(flatten_with_paths(port_tree))
    assert out and len(out) <= len(ref) * max(1, cfg.n_layers)
    for path, leaf in out:
        rp, stacked = _ref_path(path, cfg, cache)
        rleaf = ref[rp]
        assert tuple(rleaf.shape)[int(stacked):] == tuple(leaf.shape), path
        yield path, leaf, rp, rleaf, stacked


@pytest.mark.parametrize("arch", ASSIGNED)
def test_rules_equal_the_references_leaf_for_leaf(arch):
    """param_pspec (tp and 2d), cache_pspec (tp and decode2d, dense and
    paged caches), engine_param_shardings and engine_cache_pspec over
    every leaf of the reduced config, on both production meshes and on
    2- and 4-way TP meshes."""
    import jax.numpy as jnp

    cfg, jcfg = get_reduced_config(arch), jax_reduced(arch)
    model, jmodel = build_model(cfg), jax_build_model(jcfg, remat=False)
    params, jparams = model.abstract_params(), jmodel.abstract_params(
        jnp.float32)
    caches = [(make_cache(cfg, 4, 64, torch.float32, device="meta"),
               jmodel.cache_spec(4, 64, jnp.float32))]
    if not cfg.enc_dec:
        caches.append((make_cache(cfg, 4, 64, torch.float32, paged=(9, 16),
                                  device="meta"),
                       jmodel.paged_cache_spec(4, 64, 9, 16, jnp.float32)))
    n = 0
    for multi_pod, (shape, axes) in MESHES.items():
        mesh, jmesh = make_production_mesh(multi_pod=multi_pod), \
            AbstractMesh(shape, axes)
        assert dict(mesh.shape) == dict(jmesh.shape)
        for path, leaf, rp, rleaf, st in _pairs(cfg, params, jparams):
            for mode in ("tp", "2d"):
                assert sharding.param_pspec(path, leaf, mode) == _unstacked(
                    ref_sharding.param_pspec(rp, rleaf, mode), st), \
                    (path, mode)
                n += 1
        b_ax = ref_sharding._batch_spec(jmesh, 4)
        assert b_ax == sharding._batch_spec(mesh, 4)
        for cache, jcache in caches:
            for path, leaf, rp, rleaf, st in _pairs(cfg, cache, jcache,
                                                   cache=True):
                for mode in ("tp", "decode2d"):
                    got = sharding.cache_pspec(path, leaf, mesh, b_ax, mode)
                    want = ref_sharding.cache_pspec(rp, rleaf, jmesh, b_ax,
                                                    mode).spec
                    assert got == _unstacked(want, st), (path, mode)
                    n += 1
    for tp in (2, 4):
        mesh, jmesh = make_tp_mesh(tp, ["cpu"] * tp), \
            AbstractMesh((tp,), ("model",))
        got = _spec_map(params, sharding.engine_param_shardings(
            mesh, params))
        want = dict(jax_flatten(ref_sharding.engine_param_shardings(
            jmesh, jparams)))
        for path, leaf, rp, rleaf, st in _pairs(cfg, params, jparams):
            assert got[path] == _unstacked(want[rp].spec, st), path
            n += 1
        for cache, jcache in caches:
            for path, leaf, rp, rleaf, st in _pairs(cfg, cache, jcache,
                                                   cache=True):
                assert sharding.engine_cache_pspec(path, leaf, mesh) == \
                    _unstacked(ref_sharding.engine_cache_pspec(
                        rp, rleaf, jmesh), st), path
                n += 1
    assert n > 100


def test_engine_param_shardings_is_the_tree_of_leaf_specs():
    """``engine_param_shardings`` over a whole tree gives each leaf the
    spec the leaf rule gives it (tuples stay leaves of the spec tree)."""
    cfg = get_reduced_config("qwen3-0.6b")
    params = build_model(cfg).abstract_params()
    mesh = make_tp_mesh(2, ["cpu", "cpu"])
    specs = sharding.engine_param_shardings(mesh, params)
    assert specs["layers"][0]["attn"]["wq"] == (None, "model")
    assert specs["layers"][0]["attn"]["wo"] == ("model", None)
    assert specs["layers"][0]["attn_norm"]["scale"] == (None,)
    assert specs["embed"] == sharding._fit_mesh(
        ("model", None), tuple(params["embed"].shape), mesh)


def _divides(specs, tree, mesh):
    n_sharded = 0

    def chk(path, leaf, spec):
        nonlocal n_sharded
        assert len(spec) <= len(leaf.shape), (path, spec)
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            assert dim % sharding._axis_size(mesh, ax) == 0, (path, spec)
            n_sharded += 1

    tree_map_with_path(chk, tree, specs)
    return n_sharded


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "starcoder2-15b", "rwkv6-3b",
                                  "recurrentgemma-2b", "qwen2-vl-7b"))
def test_specs_divide_the_debug_mesh_all_families(arch):
    """The launch rules on the 2x2 debug mesh divide every dim they split,
    for one reduced config per layer family (as
    tests/test_sharding_specs.py)."""
    mesh = make_debug_mesh(2, 2)
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    params = model.abstract_params()
    assert _divides(sharding.param_shardings(mesh, params), params,
                    mesh) > 0
    cache = model.cache_spec(4, 128)
    _divides(sharding.cache_shardings(mesh, cfg, cache, 4), cache, mesh)


@pytest.mark.parametrize("kwargs", [
    dict(name="tiny", family="dense", block_pattern=("attn",)),
    dict(name="tiny-w", family="dense", block_pattern=("local_attn",),
         sliding_window=16),
    dict(name="tiny-rwkv", family="ssm", block_pattern=("rwkv",),
         rwkv_head_size=16),
    dict(name="tiny-rglru", family="ssm", block_pattern=("rglru",))])
def test_engine_specs_divide_odd_dims(kwargs):
    """The engine rules hold the invariant for arbitrary dims (a 97-entry
    vocabulary, 2-head caches) on a 2-way mesh: ``_fit_mesh`` replicates
    what does not divide."""
    cfg = ModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                      d_ff=64, vocab_size=97, **kwargs)
    mesh = make_tp_mesh(2, ["cpu", "cpu"])
    model = build_model(cfg)
    params = model.abstract_params()
    assert _divides(sharding.engine_param_shardings(mesh, params), params,
                    mesh) > 0
    cache = model.cache_spec(3, 128)
    _divides(sharding.engine_cache_shardings(mesh, cache), cache, mesh)


def test_rule_unit_cases():
    """The reference's pure-Python rule cases (tests/test_sharding_dryrun.py)
    on the port's unstacked paths."""
    class Leaf:
        def __init__(self, shape):
            self.shape = shape

    assert sharding._base_spec("embed", 2) == ("model", None)
    assert sharding._base_spec("layers/0/attn/wq", 2) == (None, "model")
    assert sharding._base_spec("layers/0/attn/wo", 2) == ("model", None)
    assert sharding._base_spec("layers/0/ffn/w_up", 3) == (
        "model", None, None)
    assert sharding._base_spec("layers/3/ffn/w_up", 2) == (None, "model")
    assert sharding._base_spec("layers/0/time_mix/W_v", 2) == (
        None, "model")
    assert sharding._base_spec("layers/0/channel_mix/W_v", 2) == (
        "model", None)
    assert sharding.param_pspec("layers/0/attn/wq", Leaf((256, 256))) == (
        None, "model")
    assert sharding.param_pspec("layers/0/attn/wq", Leaf((256, 256)),
                                mode="2d", data_size=16) == ("data", "model")
    spec = sharding.param_pspec("layers/0/rec/conv_w", Leaf((4, 256)),
                                mode="2d", data_size=16)
    assert spec[0] is None
    # a rule whose rank mismatches the leaf replicates
    assert sharding.param_pspec("layers/0/attn/wq", Leaf((256,))) == (None,)
    mesh = make_production_mesh(multi_pod=True)
    assert sharding.input_shardings(mesh, None, {"t": Leaf((32, 8))}) == {
        "t": (("pod", "data"), None)}
    assert sharding.input_shardings(mesh, None, {"t": Leaf((1, 8))}) == {
        "t": (None, None)}
    assert sharding.input_shardings(mesh, None, {"t": Leaf((32, 8))},
                                    mode="decode2d") == {"t": (None, None)}


def test_mesh_helpers_raise_actionable_errors():
    """``make_tp_mesh`` over too few GPUs names the mesh and the way to
    co-locate shards; a device that is not there raises; the dry-run's
    meshes are abstract (``meta``) and need no device."""
    with pytest.raises(ValueError) as exc:
        make_tp_mesh(64)
    msg = str(exc.value)
    assert "make_tp_mesh(64)" in msg and "devices=" in msg
    for bad in (lambda: make_tp_mesh(0),
                lambda: make_tp_mesh(2, ["cpu"] * 3),
                lambda: make_tp_mesh(1, ["cuda:7"])):
        with pytest.raises(ValueError):
            bad()
    mesh = make_tp_mesh(2, ["cpu", "cpu"])
    assert mesh == make_tp_mesh(2, [torch.device("cpu")] * 2)
    assert hash(mesh) == hash(make_tp_mesh(2, ["cpu", "cpu"]))
    assert mesh.shape["model"] == 2 and "model" in mesh.axis_names
    for multi_pod, (shape, axes) in MESHES.items():
        m = make_production_mesh(multi_pod=multi_pod)
        assert m.axis_names == axes and m.size == int(np.prod(shape))
        assert {d.type for d in m.devices} == {"meta"}
        assert batch_axes(m) == (("pod", "data") if multi_pod
                                 else ("data",))
    assert make_debug_mesh(16, 16).shape == {"data": 16, "model": 16}
    with pytest.raises(ValueError):
        TPMesh((torch.device("cpu"),), ("model",), {"model": 2})


def test_shard_tree_and_bytes_per_device():
    """Slices concatenate back to the leaf, in rank order on each rank's
    device; a replicated leaf is the same tensor on a shared device;
    bytes_per_device sums each rank's slice (rounded up where a split
    does not divide)."""
    mesh = make_tp_mesh(2, ["cpu", "cpu"])
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "v": torch.arange(6.0), "n": 3}
    specs = {"w": (None, "model"), "v": (None,), "n": ()}
    ranks = sharding.shard_tree(tree, specs, mesh)
    assert torch.equal(torch.cat([r["w"] for r in ranks], 1), tree["w"])
    assert all(r["v"] is tree["v"] and r["n"] == 3 for r in ranks)
    assert ranks[0]["w"].data_ptr() != tree["w"].data_ptr()
    dev = make_production_mesh()
    shapes = {"a": torch.empty((16, 33), device="meta"),
              "b": torch.empty((5,), dtype=torch.int32, device="meta")}
    got = sharding.bytes_per_device(
        shapes, {"a": ("data", "model"), "b": (None,)}, dev)
    assert got == 1 * 3 * 4 + 5 * 4
    assert sharding.bytes_per_device(shapes, {"a": (None, None),
                                              "b": (None,)}, dev,
                                     torch.bfloat16) == (16 * 33 + 5) * 2
    with pytest.raises(ValueError):
        sharding.shard_tree(tree, specs, dev)


def test_jax_abstract_meshes_take_named_shardings():
    """The comparison's reference meshes are abstract: ``NamedSharding``
    accepts them in this jax (no 512-device subprocess needed)."""
    from jax.sharding import PartitionSpec as P
    for shape, axes in MESHES.values():
        assert NamedSharding(AbstractMesh(shape, axes), P("model")).spec \
            == P("model")
