"""The port's multi-model instance pool (``repro_torch.serving.runtime``)
on the CPU: the reference's pool tests (tests/test_runtime.py:31-240 and
the pool half of tests/test_paged_kv.py) mirrored on the port, then the
port's pool held against the JAX pool: with the reference's weights
bridged in, the same submit schedule under a fixed pool clock gives
identical greedy token streams and identical instance assignment per
request, under the dense and the paged layout.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config.base import ModelConfig as JaxModelConfig
from repro.serving.runtime import ModelInstancePool as JaxPool
from repro_torch.config.base import ModelConfig
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.latency_model import (fit_contention,
                                               predicted_iter_ms)
from repro_torch.serving.runtime import (DRAINING, RETIRED, RUNNING,
                                         ModelInstancePool)

SPEC_A = dict(name="tiny-a", family="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=97)
SPEC_B = dict(name="tiny-b", family="dense", n_layers=2, d_model=48,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=83)
TINY_A, TINY_B = ModelConfig(**SPEC_A), ModelConfig(**SPEC_B)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(rng, vocab=97, n=None):
    return rng.integers(1, vocab, n or rng.integers(4, 12)).astype(np.int32)


def _pool(**kw):
    kw.setdefault("max_instances", 4)
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("device", "cpu")
    return ModelInstancePool({"tiny-a": TINY_A}, **kw)


# ------------------------------------------------------------ router
def test_router_admits_by_deadline():
    pool = _pool(max_slots=1)
    pool.scale_to("tiny-a", 1)
    rng = np.random.default_rng(0)
    t = pool.now()
    loose = pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                        max_new_tokens=2, submit_s=t)
    tight = pool.submit("tiny-a", _prompt(rng), slo_ms=5_000.0,
                        max_new_tokens=2, submit_s=t)
    mid = pool.submit("tiny-a", _prompt(rng), slo_ms=30_000.0,
                      max_new_tokens=2, submit_s=t)
    res = pool.run_until_drained()
    assert len(res) == 3
    assert [rid for rid, _ in pool.admission_log] == [tight, mid, loose]


def test_router_balances_across_instances():
    pool = _pool(max_slots=2)
    pool.scale_to("tiny-a", 2)
    rng = np.random.default_rng(1)
    for _ in range(4):
        pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                    max_new_tokens=2)
    pool.step()
    assert len({iid for _, iid in pool.admission_log}) == 2
    pool.run_until_drained()


def test_slot_cap_is_the_b_axis():
    pool = _pool(max_slots=2)
    pool.scale_to("tiny-a", 1)
    pool.set_slot_cap("tiny-a", 1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                    max_new_tokens=2)
    pool.step()
    assert pool.running("tiny-a")[0].n_resident == 1
    assert len(pool.run_until_drained()) == 3


def test_strict_admission_rejects_expired():
    pool = _pool(strict_admission=True)
    pool.scale_to("tiny-a", 1)
    rng = np.random.default_rng(3)
    dead = pool.submit("tiny-a", _prompt(rng), slo_ms=0.0,
                       max_new_tokens=2)
    ok = pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                     max_new_tokens=2)
    by_id = {r.request_id: r for r in pool.run_until_drained()}
    assert by_id[dead].rejected and by_id[dead].violated
    assert not by_id[ok].rejected and len(by_id[ok].tokens) == 2
    assert pool.n_rejected == 1
    assert all(rid != dead for rid, _ in pool.admission_log)


# ------------------------------------------------------------ lifecycle
def test_scale_up_down_idempotent():
    pool = _pool()
    assert pool.scale_to("tiny-a", 3) == 3
    ids = sorted(i.instance_id for i in pool.running("tiny-a"))
    assert pool.scale_to("tiny-a", 3) == 3
    assert sorted(i.instance_id for i in pool.running("tiny-a")) == ids
    assert pool.scale_to("tiny-a", 1) == 1
    states = [i.state for i in pool.instances["tiny-a"]]
    assert states.count(RUNNING) == 1 and states.count(DRAINING) == 2
    pool.scale_to("tiny-a", 1)
    assert [i.state for i in pool.instances["tiny-a"]] == states
    assert pool.scale_to("tiny-a", 2) == 2
    assert all(i.instance_id in ids for i in pool.running("tiny-a"))
    pool.step()
    assert pool.total_live() == 2
    assert sum(1 for i in pool.retired if i.model == "tiny-a") == 1


def test_scale_to_clamps_at_max_instances():
    pool = ModelInstancePool({"tiny-a": TINY_A, "tiny-b": TINY_B},
                             max_instances=3, max_slots=2, max_seq=64,
                             device="cpu")
    assert pool.scale_to("tiny-a", 2) == 2
    assert pool.scale_to("tiny-b", 4) == 1
    assert pool.total_live() == 3
    with pytest.raises(RuntimeError):
        pool.spawn("tiny-b")


def test_drain_before_retire_finishes_resident_work():
    pool = _pool()
    pool.scale_to("tiny-a", 1)
    rng = np.random.default_rng(4)
    rid = pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                      max_new_tokens=6)
    pool.step()
    pool.drain("tiny-a")
    inst = pool.live("tiny-a")[0]
    assert inst.state == DRAINING and inst.n_resident == 1
    late = pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                       max_new_tokens=2)
    by_id = {r.request_id: r for r in pool.run_until_drained()}
    assert len(by_id[rid].tokens) == 6
    assert late not in by_id
    assert pool.queue_len("tiny-a") == 1
    assert pool.states("tiny-a") == [RETIRED]
    pool.scale_to("tiny-a", 1)
    assert [r.request_id for r in pool.run_until_drained()] == [late]


def test_retired_instance_keeps_its_engine_stats():
    """The engine is dropped at retirement; its counters stay on the
    instance (what a launch count over every engine the pool built reads)."""
    pool = _pool()
    inst = pool.spawn("tiny-a")
    assert inst.engine_stats is None
    rng = np.random.default_rng(5)
    pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0, max_new_tokens=5)
    pool.run_until_drained()
    want = inst.engine.stats()
    pool.drain("tiny-a")
    pool.step()
    assert inst.state == RETIRED and inst.engine is None
    assert pool.retired == [inst]
    assert inst.engine_stats == want
    assert want["n_iters"] >= 4 and want["n_prefill_chunks"] >= 1


# ------------------------------------------------------------ concurrency
def test_two_model_concurrent_smoke():
    pool = ModelInstancePool({"tiny-a": TINY_A, "tiny-b": TINY_B},
                             max_instances=4, max_slots=2, max_seq=64,
                             device="cpu")
    pool.scale_to("tiny-a", 1)
    pool.scale_to("tiny-b", 1)
    rng = np.random.default_rng(5)
    for _ in range(3):
        pool.submit("tiny-a", _prompt(rng, 97), slo_ms=60_000.0,
                    max_new_tokens=3)
        pool.submit("tiny-b", _prompt(rng, 83), slo_ms=60_000.0,
                    max_new_tokens=3)
    res = pool.run_until_drained()
    assert len(res) == 6
    report = pool.report()
    assert report["tiny-a"]["served"] == 3
    assert report["tiny-b"]["served"] == 3
    assert all(len(r.tokens) == 3 for r in res)
    assert any(n >= 2 for n, _ in pool.contention_samples)


def test_pool_matches_standalone_engine_greedy():
    """Routing through the pool does not change what the model computes:
    same seed, same weights, token-identical greedy output."""
    rng = np.random.default_rng(6)
    prompt = _prompt(rng, 97, 9)
    ref_eng = ContinuousBatchingEngine(TINY_A, max_slots=2, max_seq=64,
                                       seed=0, kv_layout="dense",
                                       device="cpu")
    ref = ref_eng.run([prompt], max_new_tokens=4)[0].tokens
    pool = _pool(seed=0)
    pool.scale_to("tiny-a", 2)
    pool.submit("tiny-a", prompt, slo_ms=60_000.0, max_new_tokens=4)
    res = pool.run_until_drained()
    assert np.array_equal(res[0].tokens, ref)


def test_instances_share_weights():
    """One params dict and model per model; each instance its own KV
    cache."""
    pool = _pool(kv_layout="paged")
    pool.scale_to("tiny-a", 3)
    a, b, c = pool.running("tiny-a")
    assert a.engine.params is b.engine.params is c.engine.params
    assert a.engine.model is b.engine.model
    assert a.engine.cache[0]["k"].data_ptr() \
        != b.engine.cache[0]["k"].data_ptr()
    assert a.engine.allocator is not b.engine.allocator


# ------------------------------------------------------------ calibration
def test_fit_contention_recovers_linear_model():
    t1, c = 4.0, 0.8
    samples = [(n, predicted_iter_ms(t1, c, n)) for n in (1, 2, 3, 4) * 8]
    ft1, fc = fit_contention(samples)
    assert ft1 == pytest.approx(t1, rel=1e-6)
    assert fc == pytest.approx(c, rel=1e-6)
    ft1, fc = fit_contention([(2, 5.0), (2, 7.0)])
    assert ft1 == pytest.approx(6.0) and fc == 0.0
    assert fit_contention([]) == (0.0, 0.0)


def test_pool_records_contention_samples():
    pool = _pool()
    pool.scale_to("tiny-a", 2)
    rng = np.random.default_rng(7)
    for _ in range(6):
        pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                    max_new_tokens=3)
    pool.run_until_drained()
    assert len(pool.contention_samples) >= 3
    assert all(ms > 0.0 for _, ms in pool.contention_samples)
    t1, c = pool.contention()
    assert t1 >= 0.0 and c >= 0.0


# ------------------------------------------------------ shared KV budget
def test_pool_shared_block_budget_clamps_scale_to():
    """Dense slabs fit the budget once, right-sized paged grants four
    times; retiring instances returns their grant."""
    common = dict(max_instances=4, max_slots=2, max_seq=64, seed=0,
                  kv_block_budget=16, block_size=8, device="cpu")
    dense = ModelInstancePool({"tiny-a": TINY_A}, **common)
    assert dense.scale_to("tiny-a", 3) == 1
    paged = ModelInstancePool({"tiny-a": TINY_A}, kv_layout="paged",
                              blocks_per_instance=4, **common)
    assert paged.scale_to("tiny-a", 4) == 4
    assert paged.kv_blocks_free == 0
    occ = paged.kv_occupancy()
    assert occ["budget_tokens"] == 16 * 8 and occ["committed_blocks"] == 16
    paged.scale_to("tiny-a", 1)
    paged._sweep()
    assert paged.kv_blocks_free == 12
    assert paged.scale_to("tiny-a", 4) == 4


def test_route_does_not_oversubscribe_blocks_and_rejects_the_impossible():
    """One route() pass debits the blocks it promised (the third request
    waits in the pool queue), and a request no grant could ever hold is
    rejected instead of blocking the queue."""
    pool = _pool(max_instances=1, max_slots=4, kv_layout="paged",
                 block_size=8, kv_block_budget=6, blocks_per_instance=6)
    pool.scale_to("tiny-a", 1)
    rng = np.random.default_rng(8)
    for _ in range(3):  # each reserves bucket 16 + 8 = 3 blocks of 8
        pool.submit("tiny-a", _prompt(rng, n=10), slo_ms=60_000.0,
                    max_new_tokens=8)
    big = pool.submit("tiny-a", np.arange(1, 51, dtype=np.int32) % 97,
                      slo_ms=120_000.0, max_new_tokens=8)  # 64 + 8 > 48
    pool.route()
    inst = pool.running("tiny-a")[0]
    assert inst.n_resident == 2 and pool.queue_len("tiny-a") == 2
    res = pool.run_until_drained()
    by_id = {r.request_id: r for r in res}
    assert by_id[big].rejected
    assert sum(not r.rejected for r in res) == 3


def test_paged_pool_serves_and_calibrates_occupancy():
    pool = _pool(max_instances=2, kv_layout="paged", block_size=8,
                 kv_block_budget=32)
    pool.scale_to("tiny-a", 2)
    rng = np.random.default_rng(7)
    for _ in range(8):
        pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                    max_new_tokens=6)
    res = pool.run_until_drained()
    assert len(res) == 8 and not any(r.rejected for r in res)
    assert len(pool.occupancy_samples) >= 8
    assert 8.0 < pool.occupancy_tokens_per_seq() < 40.0
    assert pool.stats()["kv_budget_tokens"] == 32 * 8
    assert pool.kv_used_tokens() == 0


def test_lifecycle_events_and_hooks():
    """Every request walks QUEUED -> PREFILL -> DECODE -> FINISHED, its
    listener sees each phase and every token in order, and the engines'
    step counters feed the token-cost samples."""
    pool = _pool(kv_layout="paged")
    pool.scale_to("tiny-a", 1)
    rng = np.random.default_rng(9)
    rid = pool.submit("tiny-a", _prompt(rng), slo_ms=60_000.0,
                      max_new_tokens=3)
    events = []
    pool.add_listener(rid, events.append)
    res = pool.run_until_drained()
    kinds = [e["event"] for e in events]
    assert kinds == ["prefill", "decode", "token", "token", "token",
                     "finished"]
    assert [e["token"] for e in events if e["event"] == "token"] \
        == list(res[0].tokens)
    assert res[0].first_token_s >= 0 and res[0].ttft_ms >= 0
    assert rid not in pool._listeners
    assert all(n >= 1 for n, _ in pool.token_samples)
    assert pool.admission_headroom("tiny-a", 8, 4)["admissible_now"] == 1.0


@pytest.mark.parametrize("kw,what", [
    ({"preemption": True, "preempt_mode": "swap"}, "preempt_mode"),
    ({"kv_host_blocks": 4, "kv_layout": "paged"}, "kv_host_blocks"),
    ({"spec_k": 2}, "spec_k"), ({"tp_degree": 2}, "tp_degree"),
    ({"n_devices": 2}, "n_devices")])
def test_unported_pool_arguments_raise(kw, what):
    """The host tier, swap preemption, speculation and tensor parallelism
    (``tp_degree``, ``n_devices``) are ported: the pool builds as the
    reference's does and spawns engines built the same way. A tp = 2
    spawn needs two jax devices on the reference's side, so that case
    spawns on the port's side only (tests/test_torch_tp_pool.py holds
    both sides in a subprocess)."""
    ref = JaxPool({"tiny-a": JaxModelConfig(**SPEC_A)}, max_instances=4,
                  max_slots=2, max_seq=64, **kw)
    pool = _pool(**kw)
    assert (pool.tp_degrees, pool.n_devices) == (ref.tp_degrees,
                                                 ref.n_devices)
    if what == "tp_degree":
        assert pool.scale_to("tiny-a", 1) == 1
        inst = pool.running("tiny-a")[0]
        assert inst.tp_degree == inst.engine.tp_degree == 2
        assert pool.devices_in_use() == 2
        return
    for p in (ref, pool):
        p.scale_to("tiny-a", 1)
    a, b = ref.running("tiny-a")[0].engine, pool.running("tiny-a")[0].engine
    assert (b.spec_max, b.spec_k, b.kv_host_blocks, b.swap_ok) == \
        (a.spec_max, a.spec_k, a.kv_host_blocks, a.swap_ok)
    assert (pool.preempt_mode, pool.spec_cap, pool.kv_host_blocks) == \
        (ref.preempt_mode, ref.spec_cap, ref.kv_host_blocks)
    st, want = pool.stats(), ref.stats()
    for key in ("n_swap_preempted", "swap_base_ms", "swap_ms_per_mb",
                "spec_accept_rate", "devices_in_use"):
        assert st[key] == want[key]


def test_cancel_raises_and_the_default_device_is_the_gpu(monkeypatch):
    """``cancel`` is ported: it no longer raises, and an unknown id is a
    no-op (tests/test_torch_async_serving.py holds it against the
    reference). The default device is still the GPU."""
    pool = _pool()
    assert pool.cancel(0) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelInstancePool({"tiny-a": TINY_A})


# ------------------------------------------------- parity with the JAX pool
@pytest.mark.parametrize("kv_layout", ["dense", "paged", "paged-prefix"])
def test_pool_matches_the_jax_pool(kv_layout, monkeypatch):
    """Two models, two instances of one, slot caps below the engines'
    slots, a block budget (paged) and requests submitted between steps
    with deadlines out of submission order: the same instance per
    request and the same greedy tokens, with both pools' clocks held at
    one instant (routing reads the clock) and SLOs far past it. With
    "paged-prefix" the prompts share prefixes and the prefix cache is on:
    the router's affinity picks the same instances and the hit rates
    agree."""
    prefix = kv_layout == "paged-prefix"
    kv_layout = kv_layout.split("-")[0]
    kw = dict(max_instances=3, max_slots=3, max_seq=64, seed=0,
              kv_layout=kv_layout, block_size=8, prefix_cache=prefix,
              kv_block_budget=64 if kv_layout == "paged" else None)
    cfgs = {"tiny-a": SPEC_A, "tiny-b": SPEC_B}
    ref = JaxPool({m: JaxModelConfig(**s) for m, s in cfgs.items()}, **kw)
    port = ModelInstancePool({m: ModelConfig(**s) for m, s in cfgs.items()},
                             device="cpu", **kw)
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: 1.0)
        pool.scale_to("tiny-a", 2)
        pool.scale_to("tiny-b", 1)
        pool.set_slot_cap("tiny-a", 2)
    for m in cfgs:
        port.load_jax_params(m, jax.tree.map(
            np.asarray, ref.running(m)[0].engine.params))
    rng = np.random.default_rng(10)
    heads = {m: [np.random.default_rng(i).integers(
        1, s["vocab_size"], 20).astype(np.int32) for i in range(2)]
        for m, s in cfgs.items()}
    schedule = []  # (step, model, prompt, slo_ms, max_new)
    for step in range(6):
        for _ in range(int(rng.integers(1, 4))):
            m = ("tiny-a", "tiny-b")[int(rng.integers(2))]
            vocab = cfgs[m]["vocab_size"]
            p = _prompt(rng, vocab)
            if prefix:  # one of two shared 20-token heads, tail of 4
                p = np.concatenate([heads[m][int(rng.integers(2))],
                                    p[:4] % vocab])
            schedule.append((step, m, p,
                             float(rng.integers(10, 100)) * 1000.0,
                             int(rng.integers(2, 7))))
    out = {}
    for name, pool in (("ref", ref), ("port", port)):
        res = []
        for step in range(6):
            for s, m, p, slo, n in schedule:
                if s == step:
                    pool.submit(m, p, slo_ms=slo, max_new_tokens=n,
                                submit_s=1.0)
            res += pool.step()
        res += pool.run_until_drained()
        out[name] = ({r.request_id: (r.model, r.instance_id,
                                     list(r.tokens)) for r in res},
                     list(pool.admission_log),
                     pool.prefix_hit_rate() if prefix else 0.0)
    assert len(out["ref"][0]) == len(schedule)
    assert out["port"][1] == out["ref"][1]
    assert out["port"][0] == out["ref"][0]
    assert len({iid for _, iid in out["ref"][1]}) == 3
    assert out["port"][2] == out["ref"][2]
    assert (out["ref"][2] > 0) == prefix
