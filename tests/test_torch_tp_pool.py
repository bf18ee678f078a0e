"""The pool's device set and the scheduler's TP axis on the CPU, against
the reference (its tests/test_sharded_engine.py pool and guard tests,
mirrored).

The port's pool builds a degree-d instance over d shards on the CPU
device; the reference's needs d jax devices, so where a reference pool
must spawn at tp = 2 it runs in a subprocess with
``--xla_force_host_platform_device_count=8``, as its own tests do. The
schedulers are compared action for action with the port's link constant
and payload set to the reference's (``ICI_BW``, 2 bytes).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.config.base import ModelConfig as JaxModelConfig
from repro.launch.roofline import ICI_BW
from repro.serving.bcedge import \
    tp_collective_ms_per_token as jax_collective_ms
from repro_torch.config import get_config
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.serving import bcedge
from repro_torch.serving.bcedge import (POOL_STATE_DIM, PoolScheduler,
                                        tp_collective_ms_per_token)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPEC2 = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=2, d_ff=64, vocab_size=97)
SPEC4 = dict(SPEC2, name="tiny4", n_heads=4, n_kv_heads=4)
TINY2, TINY4 = ModelConfig(**SPEC2), ModelConfig(**SPEC4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 97, 20).astype(np.int32)
    ps = [np.concatenate([shared, rng.integers(1, 97, n).astype(np.int32)])
          for n in (4, 12)]
    return ps + [rng.integers(1, 97, 9).astype(np.int32), ps[0].copy()]


def test_pool_spawns_tp_instances():
    """The reference's numbers: two tp = 2 instances span 4 devices; the
    32-block dense-equivalent grant charges 16 budget blocks each while
    the engine keeps 32; same-degree instances share one template; the
    streams equal a plain engine's; a degree change drains the old
    instances and respawns at the new degree; stats carry the device
    set."""
    pool = ModelInstancePool({"tiny": TINY2}, max_instances=4, max_slots=2,
                             max_seq=128, kv_layout="paged", block_size=8,
                             kv_block_budget=64, tp_degree=2, n_devices=8,
                             device="cpu")
    assert pool.scale_to("tiny", 2) == 2
    insts = pool.running("tiny")
    assert all(i.tp_degree == 2 == i.engine.tp_degree for i in insts)
    assert pool.devices_in_use() == 4
    for i in insts:
        assert i.kv_blocks == 16 and i.engine.allocator.n_blocks == 32
        assert i.engine.kv_host_blocks == 0
    assert pool.kv_blocks_free == 64 - 32
    assert list(pool._templates) == [("tiny", 2)]
    assert insts[1].engine.params is insts[0].engine.params

    ref = ContinuousBatchingEngine(TINY2, max_slots=1, max_seq=128, seed=0,
                                   device="cpu")
    want = [ref.run([p], max_new_tokens=4)[0].tokens for p in _prompts()]
    rids = {pool.submit("tiny", p, slo_ms=60_000.0, max_new_tokens=4): i
            for i, p in enumerate(_prompts())}
    got = {rids[r.request_id]: r.tokens for r in pool.run_until_drained()}
    for i, w in enumerate(want):
        assert np.array_equal(got[i], w), (i, got[i], w)
    assert pool.stats()["devices_in_use"] == 4.0
    assert pool.report()["tiny"]["tp_degree"] == 2.0
    assert 2 in pool.tp_token_samples and not (set(pool.tp_token_samples)
                                                - {2})

    pool.set_tp_degree("tiny", 1)
    assert not pool.running("tiny")
    assert pool.scale_to("tiny", 1) == 1
    inst = pool.running("tiny")[0]
    assert inst.tp_degree == 1 and inst.engine.mesh is None
    assert inst.kv_blocks == inst.engine.allocator.n_blocks == 32
    pool.step()
    assert pool.devices_in_use() == 1
    assert pool.kv_blocks_free == 64 - 32
    assert pool.token_cost(2) == pool.token_cost()  # < 8 samples each


def test_pool_device_budget_bounds_joint_partition():
    """m_c and the degree partition the device set together: scale_to
    clamps where Σ tp would pass n_devices (the reference's numbers)."""
    pool = ModelInstancePool({"tiny4": TINY4}, max_instances=8, max_slots=2,
                             max_seq=128, tp_degree=4, n_devices=8,
                             device="cpu")
    assert pool.scale_to("tiny4", 3) == 2   # 3 x tp=4 > 8 devices
    assert pool.devices_in_use() == 8
    assert not pool.can_spawn("tiny4")
    with pytest.raises(RuntimeError, match="device budget"):
        pool.spawn("tiny4")
    pool.set_tp_degree("tiny4", 1)
    pool._sweep()                           # retire the drained pair
    assert pool.devices_in_use() == 0
    assert pool.scale_to("tiny4", 3) == 3
    assert pool.devices_in_use() == 3


def test_guard_degrades_tp_degree_before_concurrency():
    """An infeasible degree steps down before m_c or b (the ladder k ->
    token budget -> tp -> m_c -> b); the 12th state feature is the device
    set's utilisation (as the reference's test)."""
    pool = ModelInstancePool({"tiny": TINY2}, max_instances=2, max_slots=2,
                             max_seq=64, device="cpu")
    pool.n_devices = 1
    scfg = ServingConfig(batch_sizes=(1, 2), concurrency_levels=(1,),
                         tp_degrees=(1, 2))
    sched = PoolScheduler(pool, scfg, slo_ms={"tiny": 1000.0},
                          decode_steps_mean=1.0, learn=False, seed=0)
    applied = sched._apply("tiny", scfg.quint_to_action(2, 1, 0, 0, 2))
    assert scfg.action_to_quint(applied) == (2, 1, 0, 0, 1)
    assert sched.guard_interventions == 1
    assert pool.tp_degrees["tiny"] == 1
    s = sched._state("tiny")
    assert s.shape == (POOL_STATE_DIM,)
    pool.scale_to("tiny", 1)
    assert sched._state("tiny")[11] == 1.0  # 1 of 1 devices in use


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "yi-34b", "chatglm3-6b"])
def test_collective_surcharge_is_the_references(arch, monkeypatch):
    """``tp_collective_ms_per_token`` equals the reference's with the
    reference's link (ICI_BW) and payload (bf16's 2 bytes) substituted;
    with the port's own (NVLink, fp32) it is that ratio apart."""
    from repro.config import get_config as jax_get_config

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    own = {tp: tp_collective_ms_per_token(cfg, tp) for tp in (1, 2, 4, 8)}
    monkeypatch.setattr(bcedge, "LINK_BW", ICI_BW)
    monkeypatch.setattr(bcedge, "TP_PAYLOAD_BYTES", 2)
    for tp in (1, 2, 4, 8):
        want = jax_collective_ms(jcfg, tp)
        assert tp_collective_ms_per_token(cfg, tp) == pytest.approx(
            want, rel=1e-12)
        assert own[tp] == pytest.approx(
            want * 4 / 2 * ICI_BW / 450e9, rel=1e-12)


#: the action sequence both schedulers apply: every action of a config
#: with three batch sizes, three concurrencies and degrees (1, 2), in a
#: fixed shuffled order, on a pool of 4 devices and 4 instances
SCHED = dict(batch_sizes=(1, 2, 4), concurrency_levels=(1, 2, 3),
             tp_degrees=(1, 2))
POOL_KW = dict(max_instances=4, max_slots=2, max_seq=64, kv_layout="paged",
               block_size=8, kv_block_budget=64, n_devices=4)
#: slack floor 2 ms over this many decode steps: a budget of 2.5e-5 ms an
#: iteration, where the per-token collective surcharge of tp = 2 (at the
#: reference's link) rules out the larger batches
STEPS_MEAN = 1.0e5


def _order():
    return [int(a) for a in np.random.default_rng(4).permutation(
        ServingConfig(**SCHED).n_actions)] * 2


_SUB = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.config.base import ModelConfig, ServingConfig
from repro.serving.bcedge import PoolScheduler
from repro.serving.runtime import ModelInstancePool
spec, kw, sched_kw, order, steps = json.loads(os.environ["TP_SCHED"])
for k in ("batch_sizes", "concurrency_levels", "tp_degrees"):
    sched_kw[k] = tuple(sched_kw[k])
pool = ModelInstancePool({"tiny": ModelConfig(**spec)}, **kw)
sched = PoolScheduler(pool, ServingConfig(**sched_kw), slo_ms={"tiny": 1000.0},
                      decode_steps_mean=steps, learn=False, seed=0)
rows = []
for a in order:
    got = sched._apply("tiny", a)
    rows.append([got, pool.m_c("tiny"), pool.tp_degrees["tiny"],
                 pool.devices_in_use(), pool.total_live(),
                 pool.kv_blocks_free, sched.guard_interventions,
                 [float(x) for x in sched._state("tiny")[[2, 3, 6, 11]]]])
print("ROWS" + json.dumps(rows))
"""


def test_apply_matches_the_reference_action_for_action(monkeypatch):
    """``PoolScheduler._apply`` over a fixed action sequence on a pool
    with a device set: the applied action, m_c, degree, devices in use,
    live instances, free blocks, guard interventions and the device
    features of the state equal the reference's at every step (its pool
    in a subprocess with 8 host devices)."""
    order = _order()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    env["TP_SCHED"] = json.dumps([SPEC2, POOL_KW, SCHED, order, STEPS_MEAN])
    out = subprocess.run([sys.executable, "-c", _SUB], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.split("ROWS", 1)[1])

    monkeypatch.setattr(bcedge, "LINK_BW", ICI_BW)
    monkeypatch.setattr(bcedge, "TP_PAYLOAD_BYTES", 2)
    pool = ModelInstancePool({"tiny": TINY2}, device="cpu", **POOL_KW)
    sched = PoolScheduler(pool, ServingConfig(**SCHED),
                          slo_ms={"tiny": 1000.0},
                          decode_steps_mean=STEPS_MEAN, learn=False, seed=0)
    got = []
    for a in order:
        applied = sched._apply("tiny", a)
        got.append([applied, pool.m_c("tiny"), pool.tp_degrees["tiny"],
                    pool.devices_in_use(), pool.total_live(),
                    pool.kv_blocks_free, sched.guard_interventions,
                    [float(x) for x in sched._state("tiny")[[2, 3, 6, 11]]]])
    assert got == want
    assert want[-1][6] > 0  # the guard stepped in
    assert {row[2] for row in want} == {1, 2}  # both degrees applied
    assert JaxModelConfig(**SPEC2).n_heads == TINY2.n_heads
