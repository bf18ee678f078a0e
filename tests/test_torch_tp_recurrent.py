"""Tensor-parallel serving of the RG-LRU, RWKV-6 and MoE stacks on the CPU:
the port's engine on a ``("model",)`` mesh against the reference's engine,
unsharded and (in a subprocess with forced host devices) sharded.

Every rank sits on the CPU device of this process (``make_tp_mesh(2,
["cpu"] * 2)``); weights are the reference's, bridged. Configs: the
suite's hybrid RG-LRU + attention and RWKV-6 TINY stacks
(``KIND_CFGS``) and reduced arctic-480b with two KV heads (top-2 over 4
experts, a dense residual MLP beside them), at its capacity factor and
at 1.0, where entries are dropped. The bar is the reference's: greedy
tokens identical on the dense and paged layouts; the cuts (RWKV-6 by
head, RG-LRU by width, experts over E) hold what the module says.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import KIND_CFGS
from repro.config import get_reduced_config as jax_reduced
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.runtime import ModelInstancePool as JaxPool
from repro_torch.config import get_config, get_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.launch.sharding import shard_tree
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.tp import TPModel
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _arctic(cf=None):
    cfg = dataclasses.replace(jax_reduced("arctic-480b"), n_kv_heads=2)
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, name=f"{cfg.name}-kv2-cf{cf}",
                               capacity_factor=cf)


#: the three families: the reference's configs (the port's are their
#: field-for-field copies)
FAMILIES = {"rglru": KIND_CFGS["rglru"], "rwkv": KIND_CFGS["rwkv"],
            "moe": _arctic()}
LAYOUTS = {"paged": {"kv_layout": "paged", "block_size": 8}, "dense": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _mesh(tp=2):
    return make_tp_mesh(tp, ["cpu"] * tp)


def prompts(vocab, seed=7):
    """A shared-prefix family, a one-off and a duplicate (four requests
    over three slots, so a finished slot is grafted again)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 20).astype(np.int32)
    ps = [np.concatenate([shared, rng.integers(1, vocab, n).astype(np.int32)])
          for n in (4, 12)]
    ps += [rng.integers(1, vocab, 9).astype(np.int32), ps[0].copy()]
    return ps


_JAX = {}


def _jax(jcfg, **kw):
    """The reference engine's streams (unsharded) and its params."""
    key = (jcfg.name, tuple(sorted(kw.items())))
    if key not in _JAX:
        eng = JaxEngine(jcfg, max_slots=3, max_seq=128, seed=0, **kw)
        _JAX[key] = (jax.tree.map(np.asarray, eng.params),
                     [r.tokens.tolist() for r in eng.run(
                         prompts(jcfg.vocab_size), max_new_tokens=8)])
    return _JAX[key]


def _engine(jcfg, params, mesh, **kw):
    eng = ContinuousBatchingEngine(_cfg(jcfg), max_slots=3, max_seq=128,
                                   mesh=mesh, device="cpu", **kw)
    eng.load_jax_params(params)
    return eng


def _toks(jcfg, params, mesh, **kw):
    eng = _engine(jcfg, params, mesh, **kw)
    return eng, [r.tokens.tolist() for r in eng.run(
        prompts(jcfg.vocab_size), max_new_tokens=8)]


@pytest.fixture()
def drops(monkeypatch):
    """Entries dropped in each of the port's MoE dispatches."""
    seen = []
    orig = tmoe.route

    def watched(logits, cfg):
        r = orig(logits, cfg)
        seen.append(int((~r["keep"]).sum()))
        return r
    monkeypatch.setattr(tmoe, "route", watched)
    return seen


# ------------------------------------------------------------ engines
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_stack_token_identity(family, layout):
    """tp = 2 greedy streams == the reference engine's (unsharded) on the
    layout; four requests over three slots, so one slot is reused."""
    jcfg, kw = FAMILIES[family], LAYOUTS[layout]
    params, ref = _jax(jcfg, **kw)
    eng, got = _toks(jcfg, params, _mesh(), **kw)
    assert got == ref
    assert eng.tp_degree == 2 and len(eng.params) == len(eng.cache) == 2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_drops_token_identity(layout, drops):
    """Arctic at capacity factor 1.0: entries are dropped (in the port's
    dispatch, which every rank computes over all experts), and the tp = 2
    streams still equal the reference's."""
    jcfg, kw = _arctic(1.0), LAYOUTS[layout]
    params, ref = _jax(jcfg, **kw)
    _, got = _toks(jcfg, params, _mesh(), **kw)
    assert got == ref
    assert sum(drops) > 0


def test_moe_speculation_token_identity():
    """Speculative decode with the prefix cache on the MoE stack (linear
    KV only, so both stay on) at tp = 2: the verify forward's streams
    equal the plain decode's."""
    jcfg, kw = FAMILIES["moe"], LAYOUTS["paged"]
    params, ref = _jax(jcfg, **kw)
    eng, got = _toks(jcfg, params, _mesh(), prefix_cache=True, spec_k=3,
                     **kw)
    assert got == ref and eng.n_spec_steps > 0


@pytest.mark.parametrize("family", ["rglru", "rwkv"])
def test_recompute_preemption_regrafts_every_rank(family):
    """A decoding sequence preempted (recompute) and resumed at tp = 2:
    its re-prefilled state is grafted into each rank's slot, and every
    stream equals the uninterrupted reference's."""
    jcfg = FAMILIES[family]
    params, ref = _jax(jcfg)
    eng = _engine(jcfg, params, _mesh())
    ps = prompts(jcfg.vocab_size)
    rids = [eng.submit(p, max_new_tokens=8) for p in ps]
    done = []
    while not any(s.active and not s.prefilling and len(s.tokens) >= 3
                  for s in eng.slots):
        done += eng.step()
    slot = next(i for i, s in enumerate(eng.slots)
                if s.active and not s.prefilling and len(s.tokens) >= 3)
    eng.preempt(slot)
    while eng.waiting or eng.active_slots:
        done += eng.step()
    got = {r.request_id: r.tokens.tolist() for r in done}
    assert eng.n_preempted == 1
    assert [got[r] for r in rids] == ref


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rank_caches_hold_the_rank_slices(family):
    """Each rank's cache and weights under the cuts: RG-LRU's ``h`` and
    ``conv`` at width w / 2, RWKV-6's ``att_state`` at H / 2 heads beside
    whole shifts, and E / 2 experts a rank with the router's columns."""
    jcfg = FAMILIES[family]
    cfg = _cfg(jcfg)
    eng = ContinuousBatchingEngine(cfg, max_slots=3, max_seq=64,
                                   mesh=_mesh(), device="cpu")
    kinds = cfg.layer_kinds()
    for rank in range(2):
        c, p = eng.cache[rank], eng.params[rank]
        for i, kind in enumerate(kinds):
            if kind == "rglru":
                w = cfg.rglru_width or cfg.d_model
                assert c[i]["h"].shape == (3, w // 2)
                assert c[i]["conv"].shape == (3, 3, w // 2)
                assert p["layers"][i]["rec"]["W_a"].shape == (w, w // 2)
            elif kind == "rwkv":
                H, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
                assert c[i]["att_state"].shape == (3, H // 2, hd, hd)
                assert c[i]["att_shift"].shape == (3, cfg.d_model)
                assert p["layers"][i]["time_mix"]["u"].shape == (H // 2, hd)
            if cfg.n_experts and kind != "attn_dense":
                ffn = p["layers"][i]["ffn"]
                E = cfg.n_experts
                assert ffn["w_gate"].shape[0] == E // 2
                assert ffn["router"].shape == (cfg.d_model, E // 2)


# ------------------------------------------------------------ the cuts
@pytest.mark.parametrize("tp", [2, 4])
def test_rwkv_u_and_att_state_cut_by_head(tp):
    """The reference's spec cuts ``u`` (H, hd) over hd; the port cuts it
    by head: rank r holds rows [r H/tp, (r+1) H/tp), whole heads, and its
    ``att_state`` those heads' (hd, hd) states. A rank's time mix from the
    whole state's head slice equals the unsplit time mix's heads."""
    cfg = get_reduced_config("rwkv6-3b")
    H, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    params = build_model(cfg).init(0, device="cpu")
    tpm = TPModel(cfg, _mesh(tp))
    shards = tpm.shard_params(params)
    u = params["layers"][0]["time_mix"]["u"]
    n = H // tp
    for r, p in enumerate(shards):
        assert torch.equal(p["layers"][0]["time_mix"]["u"],
                           u[r * n:(r + 1) * n])
        assert p["layers"][0]["time_mix"]["W_r"].shape == (
            cfg.d_model, n * hd)
        assert p["layers"][0]["time_mix"]["B_w"].shape == (32, cfg.d_model)
    caches = tpm.init_cache(2, 16)
    assert all(c[0]["att_state"].shape == (2, n, hd, hd) for c in caches)


@pytest.mark.parametrize("tp", [2, 4])
def test_capacity_is_global_under_an_expert_split(tp, drops):
    """``route`` sizes the capacity from all E experts however they are
    split, so each rank's ``experts_out`` over its E / tp experts keeps
    exactly the unsplit layer's entries: the ranks' partials sum to the
    unsplit output, drops included (capacity factor 0.5: 8 slots an
    expert for 12 entries an expert on average)."""
    cfg = dataclasses.replace(get_reduced_config("arctic-480b"),
                              n_experts=8, capacity_factor=0.5)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (48, cfg.d_model)).astype(np.float32))
    r = tmoe.route((x @ p["router"]).float(), cfg)
    assert r["cap"] == tmoe._capacity(48, cfg) == 8
    whole = tmoe.experts_out(p, x, r, cfg)
    n = cfg.n_experts // tp
    parts = [tmoe.experts_out(
        {k: p[k][e0:e0 + n] for k in ("w_gate", "w_up", "w_down")}, x, r,
        cfg, e0) for e0 in range(0, cfg.n_experts, n)]
    assert (sum(parts) - whole).abs().max() < 1e-5
    assert sum(drops) > 0


def _whole_cases():
    """Configs where ``_fit_mesh`` leaves one sub-block's leaves whole at
    tp = 2 while the rest split: an RG-LRU width of 33, an RWKV-6 channel
    mix of width 65 (``W_k``/``W_v`` whole, ``W_r`` split), and 3 experts
    beside arctic's split dense MLP."""
    rg, rw = _cfg(KIND_CFGS["rglru"]), _cfg(KIND_CFGS["rwkv"])
    return [dataclasses.replace(rg, name="rg-w33", rglru_width=33),
            dataclasses.replace(rw, name="rwkv-ff65", d_ff=65),
            dataclasses.replace(_cfg(FAMILIES["moe"]), name="moe-e3",
                                n_experts=3)]


@pytest.mark.parametrize("cfg", _whole_cases(), ids=lambda c: c.name)
def test_replicated_leaves_run_whole(cfg):
    """A sub-block whose leaves stay replicated runs whole on every rank
    with no collective (the reference's GSPMD replicates them too): the
    rank-split prefill and decode logits stay within 1e-5 of the unsplit
    model's."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tpm = TPModel(cfg, _mesh())
    shards = tpm.shard_params(params)
    plan = [tpm._layer_plan(s, k) for s, k in zip(shards[0]["layers"],
                                                   cfg.layer_kinds())]
    assert any(not v for p in plan for v in p.values())
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 10)))
    pos = torch.zeros(2, dtype=torch.int64)
    c1, cn = model.init_cache(2, 32, device="cpu"), tpm.init_cache(2, 32)
    a, _ = model.prefill_chunk(params, c1, {"tokens": toks, "pos": pos})
    b, _ = tpm.prefill_chunk(shards, cn, {"tokens": toks, "pos": pos})
    assert (a - b).abs().max() < 1e-5
    for j in range(2):
        batch = {"tokens": toks[:, j:j + 1], "pos": pos + 10 + j}
        a, _ = model.decode_step(params, c1, batch)
        b, _ = tpm.decode_step(shards, cn, batch)
        assert (a - b).abs().max() < 1e-5


def test_consuming_shard_tree_frees_the_whole_tree():
    """``consume=True`` gives the same shards and leaves every slot of the
    source tree empty; without it the source stays whole."""
    cfg = _cfg(FAMILIES["moe"])
    params = build_model(cfg).init(0, device="cpu")
    tpm = TPModel(cfg, _mesh())
    kept = tpm.shard_params(params)
    eaten = tpm.shard_params(params, consume=True)
    assert params.keys() == kept[0].keys()
    assert all(v is None for v in params.values())
    for a, b in zip(kept, eaten):
        assert a.keys() == b.keys()
        for i, (la, lb) in enumerate(zip(a["layers"], b["layers"])):
            for key in ("w_gate", "router"):
                assert torch.equal(la["ffn"][key], lb["ffn"][key])
    inner = [torch.ones(2), 3]
    one = {"w": torch.arange(8.0).reshape(2, 4), "n": inner}
    ranks = shard_tree(one, {"w": (None, "model"), "n": [(None,), ()]},
                       _mesh(), consume=True)
    assert one == {"w": None, "n": None} and inner == [None, None]
    assert ranks[0]["n"][1] == 3
    assert torch.equal(ranks[1]["w"], torch.tensor([[2., 3.], [6., 7.]]))


def test_engine_takes_consumed_shards():
    """A caller hands an engine shards it cut with ``consume=True`` (the
    card's arctic-480b path): the engine serves them as they are, with the
    streams of the whole params; a shard list needs a mesh of its
    degree."""
    jcfg, kw = FAMILIES["moe"], LAYOUTS["paged"]
    jparams, ref = _jax(jcfg, **kw)
    cfg = _cfg(jcfg)
    params = params_from_jax(jparams, cfg)
    shards = TPModel(cfg, _mesh()).shard_params(params, consume=True)
    eng = ContinuousBatchingEngine(cfg, max_slots=3, max_seq=128,
                                   mesh=_mesh(), device="cpu",
                                   params=shards, **kw)
    assert eng.params is shards
    got = [r.tokens.tolist() for r in eng.run(prompts(cfg.vocab_size),
                                                max_new_tokens=8)]
    assert got == ref
    with pytest.raises(ValueError, match="shards"):
        ContinuousBatchingEngine(cfg, device="cpu", params=shards)


# ------------------------------------------------------------ refusals
def _refusals():
    rwkv3 = dataclasses.replace(_cfg(KIND_CFGS["rwkv"]), name="rwkv3",
                                d_model=96)
    return {
        # one KV head: the reference's "must divide" at every tp >= 2
        "recurrentgemma-2b": (get_config("recurrentgemma-2b"), {},
                              ValueError, "must divide"),
        "recurrentgemma-reduced": (get_reduced_config("recurrentgemma-2b"),
                                   {}, ValueError, "must divide"),
        # 3 RWKV-6 heads at tp = 2 (n_heads 2 divides): the time mix
        # splits by head
        "rwkv-3-heads": (rwkv3, {}, ValueError, "RWKV-6 head count"),
        "frontend": (dataclasses.replace(get_reduced_config("qwen2-vl-7b"),
                                         n_kv_heads=2), {},
                     NotImplementedError, "frontend"),
        "encoder-decoder": (dataclasses.replace(
            get_reduced_config("seamless-m4t-large-v2"), n_kv_heads=2), {},
            NotImplementedError, "encoder-decoder"),
        "host-tier-rwkv": (_cfg(KIND_CFGS["rwkv"]),
                           {"kv_layout": "paged", "kv_host_blocks": 4},
                           ValueError, "host KV tier"),
        "host-tier-moe": (_cfg(FAMILIES["moe"]),
                          {"kv_layout": "paged", "kv_host_blocks": 4},
                          ValueError, "host KV tier"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_what_stays_refused(case):
    """What the port still refuses under a mesh: a degree that does not
    divide the heads (recurrentgemma-2b's one KV head, as the reference;
    RWKV-6's own head count), frontend and encoder-decoder engines, and
    the host KV tier on the newly split stacks."""
    cfg, kw, exc, match = _refusals()[case]
    with pytest.raises(exc, match=match):
        ContinuousBatchingEngine(cfg, max_slots=1, max_seq=64,
                                 mesh=_mesh(), device="cpu", **kw)


def test_encoder_decoder_rank_split_refused():
    """``TPModel`` itself refuses an encoder-decoder config (the engine
    refuses it first, before the mesh)."""
    cfg = dataclasses.replace(get_reduced_config("seamless-m4t-large-v2"),
                              n_kv_heads=2)
    with pytest.raises(NotImplementedError, match="single-device"):
        TPModel(cfg, _mesh())


# ------------------------------------------------------------ the pool
@pytest.mark.parametrize("family", ["rwkv", "moe"])
def test_pool_spawns_tp2_recurrent_and_moe(family):
    """``set_tp_degree`` respawns the RWKV-6 or MoE model at tp = 2; the
    device budget counts two devices an instance; per-request tokens
    equal the reference pool's (at tp = 1: its tp = 2 pool needs forced
    devices, and the subprocess test below holds the sharded
    reference)."""
    jcfg = FAMILIES[family]
    cfg = _cfg(jcfg)
    kw = dict(max_instances=2, max_slots=2, max_seq=128, kv_layout="paged",
              block_size=8, kv_block_budget=64)
    jpool = JaxPool({cfg.name: jcfg}, **kw)
    jpool.scale_to(cfg.name, 1)
    jrids = {jpool.submit(cfg.name, p, slo_ms=60_000.0, max_new_tokens=4): i
             for i, p in enumerate(prompts(cfg.vocab_size))}
    want = {jrids[r.request_id]: r.tokens.tolist()
            for r in jpool.run_until_drained()}
    jparams = jax.tree.map(np.asarray, jpool.running(cfg.name)[0]
                           .engine.params)

    pool = ModelInstancePool({cfg.name: cfg}, n_devices=4, device="cpu",
                             **kw)
    pool.set_tp_degree(cfg.name, 2)
    assert pool.scale_to(cfg.name, 2) == 2
    insts = pool.running(cfg.name)
    assert pool.devices_in_use() == 4 and not pool.can_spawn(cfg.name)
    assert all(i.tp_degree == 2 == i.engine.tp_degree for i in insts)
    insts[0].engine.load_jax_params(jparams)
    assert insts[1].engine.params is insts[0].engine.params
    rids = {pool.submit(cfg.name, p, slo_ms=60_000.0, max_new_tokens=4): i
            for i, p in enumerate(prompts(cfg.vocab_size))}
    got = {rids[r.request_id]: r.tokens.tolist()
           for r in pool.run_until_drained()}
    assert got == want
    assert pool.report()[cfg.name]["tp_degree"] == 2.0


# ------------------------------------------------ the sharded reference
_SUB = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
from repro.config.base import ModelConfig
from repro.launch.mesh import make_tp_mesh
from repro.serving.engine import ContinuousBatchingEngine
cases, ps = json.loads(os.environ["TP_REF"])
out = {}
for name, spec, kw in cases:
    spec = {k: tuple(v) if isinstance(v, list) else v
            for k, v in spec.items()}
    eng = ContinuousBatchingEngine(ModelConfig(**spec), max_slots=3,
                                   max_seq=128, seed=0,
                                   mesh=make_tp_mesh(2), **kw)
    out[name] = [r.tokens.tolist() for r in eng.run(
        [np.asarray(p, np.int32) for p in ps[name]], max_new_tokens=8)]
print("TOKS" + json.dumps(out))
"""


def _spec(jcfg):
    d = dataclasses.asdict(jcfg)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def test_against_the_references_sharded_engine():
    """The three families at tp = 2 on the paged layout (RWKV-6 also
    dense) against the reference's SHARDED engine (``jit`` under its
    ``NamedSharding``s on 8 forced host devices, in a subprocess): the
    same seed gives the same weights, and the greedy streams are
    identical to the port's at tp = 2 and to the reference's unsharded
    engine."""
    cases = [("rglru", FAMILIES["rglru"], LAYOUTS["paged"]),
             ("rwkv", FAMILIES["rwkv"], LAYOUTS["paged"]),
             ("rwkv-dense", FAMILIES["rwkv"], {}),
             ("moe", FAMILIES["moe"], LAYOUTS["paged"])]
    ps = {name: [p.tolist() for p in prompts(jcfg.vocab_size)]
          for name, jcfg, _ in cases}
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    env["TP_REF"] = json.dumps([[[n, _spec(c), kw] for n, c, kw in cases],
                                 ps])
    out = subprocess.run([sys.executable, "-c", _SUB], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    sharded = json.loads(out.stdout.split("TOKS", 1)[1])
    for name, jcfg, kw in cases:
        params, ref = _jax(jcfg, **kw)
        _, got = _toks(jcfg, params, _mesh(), **kw)
        assert sharded[name] == ref == got, name
