"""Recompute preemption on the port, held against the reference on the CPU.

tests/test_preemption.py's engine and pool tests, mirrored: each schedule
of submits, steps and preemptions runs through the JAX engine (or pool)
and through the port's with the reference's weights bridged in, and the
two must agree on the greedy tokens, ``n_preempted``, ``truncated``, the
instance of every request and the counters, besides the reference test's
own invariants (blocks returned, resumed output equal to an
uninterrupted run, the victim choice, hysteresis, no thrash). The pools'
clocks are frozen and their contention fit pinned, since preemption reads
both. Last, the ``PoolScheduler``'s state vectors and greedy decisions
equal the reference's over a schedule where preemption fires.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import TINY, make_pool
from repro.config.base import ServingConfig as JaxServingConfig
from repro.core.sac import SACAgent as JaxSAC
from repro.core.sac import SACConfig as JaxSACConfig
from repro.serving.bcedge import PoolScheduler as JaxScheduler
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.sac import NETS, SACAgent, SACConfig
from repro_torch.models.bridge import sac_nets_from_jax
from repro_torch.serving.bcedge import PoolScheduler
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        PreemptedRequest, to_recompute)
from repro_torch.serving.runtime import ModelInstancePool

TTINY = ModelConfig(**dataclasses.asdict(TINY))
#: the contention fit both pools are pinned to: (t1 ms, c); preemption
#: predicts service time from it, and the measured one differs between
#: the two frameworks
FIT = (5.0, 0.1)

_TEMPLATE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(rng, n):
    return rng.integers(1, 97, n).astype(np.int32)


def _engines(max_slots, max_seq=128, **kw):
    """(reference engine, port engine) with the reference's weights in
    both; the reference engines share one template's jit caches."""
    tmpl = _TEMPLATE.get("engine")
    je = JaxEngine(TINY, max_slots=max_slots, max_seq=max_seq, seed=0,
                   share_from=tmpl, **kw)
    if tmpl is None:
        _TEMPLATE["engine"] = je
    te = ContinuousBatchingEngine(TTINY, max_slots=max_slots,
                                  max_seq=max_seq, device="cpu", **kw)
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    return je, te


def _summary(results):
    return [(r.request_id, list(map(int, r.tokens)), r.n_preempted,
             r.truncated, r.cancelled, r.n_iters) for r in results]


# ------------------------------------------------- engine mechanics
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_preempt_returns_blocks_and_resumes_identically(layout):
    """A preempted sequence's blocks all return to the allocator, and
    after resume both engines emit the uninterrupted run's tokens."""
    kw = {} if layout == "dense" else {"kv_layout": "paged",
                                       "block_size": 16}
    prompt = _prompt(np.random.default_rng(0), 20)
    out = {}
    for name, eng in zip(("ref", "port"), _engines(2, **kw)):
        ref = eng.run([prompt], max_new_tokens=10)[0].tokens
        eng.submit(prompt, max_new_tokens=10)
        for _ in range(4):  # emit a few tokens, then evict mid-sequence
            eng.step()
        [slot] = eng.decoding_slots
        if layout == "paged":
            held = len(eng.slots[slot].blocks) \
                + eng.slots[slot].n_outstanding
            avail = eng.allocator.n_available
        snap = eng.preempt(slot)  # requeued at the engine's FIFO head
        assert eng.n_preempted == 1 and snap.n_preempted == 1
        if layout == "paged":
            assert eng.allocator.n_available == avail + held
            assert eng.allocator.n_free == eng.allocator.n_blocks
            assert eng.allocator.n_reserved == 0
        done = []
        for _ in range(60):
            done.extend(eng.step())
            if done:
                break
        assert len(done) == 1 and done[0].n_preempted == 1
        np.testing.assert_array_equal(done[0].tokens, ref)
        if layout == "paged":
            assert eng.allocator.n_free == eng.allocator.n_blocks
        out[name] = (_summary(done), list(map(int, snap.seq_tokens)),
                     snap.base_len, snap.max_new, eng.stats()["n_preempted"],
                     eng.stats()["n_evicted"])
    assert out["port"] == out["ref"]


def test_preempt_refuses_mid_prefill_and_empty_slots():
    """Nothing resident, or a mid-chunk prefill: both engines raise
    ``ValueError`` and offer no candidate; ``mode="swap"`` raises the
    reference's own ``ValueError`` (no host tier in either engine)."""
    rng = np.random.default_rng(1)
    prompt = _prompt(rng, 60)  # bucket 64 > the budget of 8
    for eng in _engines(2, token_budget=8):
        with pytest.raises(ValueError):
            eng.preempt(0)
        eng.submit(prompt, max_new_tokens=2)
        eng.step()
        [slot] = eng.prefilling_slots
        with pytest.raises(ValueError, match="mid-chunk prefill"):
            eng.preempt(slot)
        assert eng.preemption_candidates() == []
        while not eng.decoding_slots:
            eng.step()
        assert not eng.can_swap(eng.decoding_slots[0])
        with pytest.raises(ValueError, match="not swappable"):
            eng.preempt(eng.decoding_slots[0], mode="swap")
        with pytest.raises(ValueError, match="unknown preempt mode"):
            eng.preempt(eng.decoding_slots[0], mode="bogus")


def test_double_preempt_round_trip_stays_token_identical():
    """Two preemptions of one sequence: both engines still reconstruct
    the uninterrupted greedy continuation, and agree token for token."""
    prompt = _prompt(np.random.default_rng(2), 12)
    out = {}
    for name, eng in zip(("ref", "port"), _engines(1)):
        ref = eng.run([prompt], max_new_tokens=12)[0].tokens
        eng.submit(prompt, max_new_tokens=12)
        done, kicked, cands = [], 0, []
        for step in range(100):
            done.extend(eng.step())
            if done:
                break
            if step in (3, 9) and eng.decoding_slots:
                cands.append(eng.preemption_candidates())
                eng.preempt(eng.decoding_slots[0])
                kicked += 1
        assert kicked == 2 and len(done) == 1
        assert done[0].n_preempted == 2
        np.testing.assert_array_equal(done[0].tokens, ref)
        out[name] = (_summary(done), cands)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_requeue_false_snapshot_resumes_on_another_engine(layout):
    """``preempt(requeue=False)`` hands back a recompute snapshot; it
    resumes through ``submit_resume`` on a second engine with the same
    weights, the pool's path. Its footprint (``resume_blocks``) and
    ``admissible(resume=...)`` agree with the reference; a swapped
    snapshot is refused by the port, and ``to_recompute`` turns it back
    into one the port takes."""
    kw = {} if layout == "dense" else {"kv_layout": "paged",
                                       "block_size": 8}
    prompt = _prompt(np.random.default_rng(3), 9)
    je, te = _engines(2, 64, **kw)
    pairs = {"ref": (je, JaxEngine(TINY, max_slots=2, max_seq=64, seed=0,
                                   share_from=je, **kw)),
             "port": (te, ContinuousBatchingEngine(
                 TTINY, max_slots=2, max_seq=64, device="cpu",
                 share_from=te, **kw))}
    out = {}
    for name, (eng, other) in pairs.items():
        full = other.run([prompt], max_new_tokens=7)[0].tokens
        eng.submit(prompt, max_new_tokens=7)
        for _ in range(3):
            eng.step()
        snap = eng.preempt(eng.decoding_slots[0], requeue=False)
        assert not eng.waiting and not eng.active_slots
        blocks = other.resume_blocks(snap) if layout == "paged" else None
        assert other.admissible(0, 0, resume=snap)
        rid = other.submit_resume(snap)
        done = []
        while not done:
            done = other.step()
        np.testing.assert_array_equal(done[0].tokens, full)
        out[name] = (rid, blocks, _summary(done), snap.base_len,
                     other.stats()["prefill_backlog_tokens"])
    assert out["port"] == out["ref"]
    swapped = PreemptedRequest(0, np.arange(16, dtype=np.int32), 16, 4, 0.0,
                               4, False, 1, tokens=[5, 6], pos=18,
                               pending_tok=7, host_blocks=[1, 2])
    eng = _engines(1, 64, **kw)[1]
    with pytest.raises(ValueError, match="host"):
        eng.submit_resume(swapped)
    with pytest.raises(ValueError, match="host pool"):
        eng.release_swap(swapped)
    rec = to_recompute(swapped)
    assert not rec.swapped and list(rec.seq_tokens[16:]) == [5, 6]
    assert eng.release_swap(rec) is rec
    eng.submit_resume(rec)


# ------------------------------------------------- pool policy
def _pools(monkeypatch, **kw):
    """(reference pool, port pool): one running instance each, the
    reference's weights in the port's, clocks frozen at ``clock[0]`` and
    contention pinned to ``FIT`` (preemption fires only once it is
    calibrated)."""
    kw.setdefault("max_instances", 2)
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("preemption", True)
    ref = make_pool(TINY, **kw)
    port = ModelInstancePool({"tiny": TTINY}, device="cpu", **kw)
    clock = [1.0]
    for pool in (ref, port):
        monkeypatch.setattr(pool, "now", lambda: clock[0])
        monkeypatch.setattr(pool, "contention", lambda: FIT)
        pool.scale_to("tiny", 1)
    port.load_jax_params("tiny", jax.tree.map(
        np.asarray, ref.running("tiny")[0].engine.params))
    return ref, port, clock


def _run_both(ref, port, clock, schedule, drain=True, max_steps=10_000):
    """Apply ``schedule`` (a list of ("submit", kwargs) or ("step", n)
    or ("tick", seconds)) to both pools in turn; returns, per pool, the
    results by request id, the admission log and the request ids."""
    out = {}
    for name, pool in (("ref", ref), ("port", port)):
        clock[0] = 1.0
        res, ids = [], []
        for op, arg in schedule:
            if op == "submit":
                ids.append(pool.submit("tiny", submit_s=clock[0], **arg))
            elif op == "tick":
                clock[0] += arg
            else:
                for _ in range(arg):
                    res += pool.step()
        if drain:
            res += pool.run_until_drained(max_steps=max_steps)
        out[name] = ({r.request_id: (list(map(int, r.tokens)),
                                     r.instance_id, r.cancelled, r.rejected)
                      for r in res}, list(pool.admission_log), ids)
    return out


def test_pool_preempts_largest_slack_for_urgent_request(monkeypatch):
    """The hog is preempted for an urgent request that cannot be
    admitted: the urgent one finishes first, the hog resumes and emits
    every token; both pools agree on every token, instance and counter."""
    ref, port, clock = _pools(monkeypatch)
    rng = np.random.default_rng(3)
    hog, urgent = _prompt(rng, 8), _prompt(rng, 6)
    out = _run_both(ref, port, clock, [
        ("submit", dict(prompt=hog, slo_ms=60_000.0, max_new_tokens=24)),
        ("step", 6),  # the hog is resident and decoding: slots full
        ("tick", 0.01),
        ("submit", dict(prompt=urgent, slo_ms=0.001, max_new_tokens=2))])
    assert out["port"] == out["ref"]
    by_id, log, (h, u) = out["port"]
    assert len(by_id[u][0]) == 2 and len(by_id[h][0]) == 24
    assert [rid for rid, _ in log] == [h, u, h]  # admitted, urgent, resumed
    for pool in (ref, port):
        assert pool.n_preempted == 1
        assert pool.report()["tiny"]["preempted"] == 1.0
        assert pool.stats()["n_preempted"] == 1.0
        fin = {r.request_id: r for r in pool.results("tiny")}
        assert fin[u].finish_s <= fin[h].finish_s
    # the uninterrupted run of the hog gives the same tokens
    solo = ContinuousBatchingEngine(TTINY, max_slots=1, max_seq=64,
                                    device="cpu",
                                    share_from=port.running("tiny")[0].engine)
    np.testing.assert_array_equal(
        solo.run([hog], max_new_tokens=24)[0].tokens, by_id[h][0])


def test_pool_preempts_the_largest_slack_victim(monkeypatch):
    """Two residents of different slack: the laxer one is evicted, in
    both pools, and resumes to its full completion."""
    ref, port, clock = _pools(monkeypatch, max_slots=2)
    rng = np.random.default_rng(4)
    out = _run_both(ref, port, clock, [
        ("submit", dict(prompt=_prompt(rng, 7), slo_ms=30_000.0,
                        max_new_tokens=16)),
        ("submit", dict(prompt=_prompt(rng, 9), slo_ms=90_000.0,
                        max_new_tokens=16)),
        ("step", 4),
        ("submit", dict(prompt=_prompt(rng, 5), slo_ms=0.001,
                        max_new_tokens=3))])
    assert out["port"] == out["ref"]
    by_id, log, (mid, lax, urgent) = out["port"]
    assert [rid for rid, _ in log] == [mid, lax, urgent, lax]
    assert all(len(by_id[r][0]) == n for r, n in
               ((mid, 16), (lax, 16), (urgent, 3)))
    assert ref.n_preempted == port.n_preempted == 1


def test_pool_preemption_holds_back_without_urgency_or_margin(
        monkeypatch):
    """Ample slack, or a victim no laxer than the waiter by the margin:
    no eviction in either pool."""
    ref, port, clock = _pools(monkeypatch)
    rng = np.random.default_rng(5)
    hog = _prompt(rng, 8)
    for slo in (60_000.0, 0.001):
        # 60 s: not urgent; 0.001 ms against a hog of 0.01 ms: urgent,
        # but the hog is not laxer by the 50 ms margin
        out = _run_both(ref, port, clock, [
            ("submit", dict(prompt=hog, slo_ms=0.01 if slo < 1 else 60_000.0,
                            max_new_tokens=24)),
            ("step", 6),
            ("submit", dict(prompt=_prompt(rng, 6), slo_ms=slo,
                            max_new_tokens=2))])
        assert out["port"] == out["ref"]
        assert ref.n_preempted == port.n_preempted == 0


def test_no_preemption_thrash_under_sustained_overload(monkeypatch):
    """Ten tight-SLO requests at once: every sequence completes in full,
    at most one eviction per cooldown window, and both pools take the
    same evictions."""
    ref, port, clock = _pools(monkeypatch)
    rng = np.random.default_rng(6)
    sched = []
    for k in range(10):  # lax and tight arrivals in turn, 3 steps apart
        sched += [("submit", dict(prompt=_prompt(rng, 6),
                                  slo_ms=0.001 if k % 2 else 60_000.0,
                                  max_new_tokens=8)), ("step", 3)]
    out = _run_both(ref, port, clock, sched)
    assert out["port"] == out["ref"]
    by_id, _, ids = out["port"]
    assert all(len(by_id[rid][0]) == 8 for rid in ids)
    assert port.n_preempted == ref.n_preempted >= 1
    assert port.n_preempted <= port.n_steps \
        // port.preempt_cooldown_steps + 1
    assert port.stats()["n_preempted"] == ref.stats()["n_preempted"]


@pytest.mark.parametrize("how", ["exhausted", "unservable"])
def test_run_until_drained_both_ways(how, monkeypatch):
    """``max_steps`` run out with work pending raises in both pools; a
    queue whose model has no running instance returns at once, no
    steps taken, in both."""
    kw = dict(max_instances=1, max_slots=1, preemption=False)
    ref = make_pool(TINY, **kw)
    port = ModelInstancePool({"tiny": TTINY}, device="cpu", max_seq=64, **kw)
    rng = np.random.default_rng(7)
    prompt = _prompt(rng, 6)
    for pool in (ref, port):
        if how == "exhausted":
            pool.scale_to("tiny", 1)
            pool.submit("tiny", prompt, slo_ms=60_000.0, max_new_tokens=8)
            with pytest.raises(RuntimeError, match="max_steps exhausted"):
                pool.run_until_drained(max_steps=2)
            assert len(pool.run_until_drained()) == 1
        else:
            pool.submit("tiny", prompt, slo_ms=60_000.0, max_new_tokens=2)
            assert pool.run_until_drained() == []
            assert pool.queue_len("tiny") == 1 and pool.n_steps == 0


def test_pool_cancel_of_a_preempted_request_returns_its_tokens(
        monkeypatch):
    """A request cancelled while its preempted snapshot waits in the EDF
    queue: both pools return the tokens it emitted before the eviction,
    and the urgent request still finishes."""
    ref, port, clock = _pools(monkeypatch)
    rng = np.random.default_rng(8)
    hog, urgent = _prompt(rng, 8), _prompt(rng, 6)
    got = {}
    for name, pool in (("ref", ref), ("port", port)):
        h = pool.submit("tiny", hog, slo_ms=60_000.0, max_new_tokens=24,
                        submit_s=1.0)
        for _ in range(6):
            pool.step()
        u = pool.submit("tiny", urgent, slo_ms=0.001, max_new_tokens=2,
                        submit_s=1.0)
        pool.step()
        assert pool.n_preempted == 1 and pool.queue_len("tiny") == 1
        res = pool.cancel(h)
        assert res.cancelled and res.instance_id == -1
        fin = pool.run_until_drained()
        got[name] = (list(map(int, res.tokens)),
                     [(r.request_id, list(map(int, r.tokens))) for r in fin],
                     pool.report()["tiny"]["cancelled"], u)
    assert got["port"] == got["ref"]
    assert got["port"][0]  # the tokens emitted before the eviction


# ------------------------------------------------- scheduler decisions
class _Greedy:
    """An agent that always acts greedily (``PoolScheduler`` calls
    ``act(s)``): decisions become a function of the state."""

    def __init__(self, agent):
        self.agent = agent

    def act(self, s):
        return self.agent.act(s, greedy=True)


SCFG = dict(batch_sizes=(1, 2, 4), concurrency_levels=(1,),
            token_budgets=(0, 64, 16))


def test_scheduler_decisions_match_where_preemption_fires(monkeypatch):
    """A preemption fires between two decision epochs: both schedulers
    see the same 13-entry state (the preemption delta included, then
    back to 0) and, with the reference's nets bridged into the port's
    agent, take the same greedy actions."""
    ref, port, clock = _pools(monkeypatch)
    for pool in (ref, port):
        monkeypatch.setattr(pool, "token_cost", lambda: (2.0, 0.5))
    n_act = ServingConfig(**SCFG).n_actions
    jagent = JaxSAC(13, n_act, JaxSACConfig(batch_size=32, lr=1e-3), seed=0)
    nets = {name: getattr(jagent.state, name) for name in NETS}
    nets["log_alpha"] = jagent.state.log_alpha
    tagent = SACAgent(13, n_act, SACConfig(batch_size=32, lr=1e-3),
                      device="cpu")
    tagent.load_nets(sac_nets_from_jax(jax.tree.map(np.asarray, nets)))
    kw = dict(slo_ms={"tiny": 4000.0}, decode_steps_mean=8.0, learn=False)
    s_ref = JaxScheduler(ref, JaxServingConfig(**SCFG),
                         agents={"tiny": _Greedy(jagent)}, **kw)
    s_port = PoolScheduler(port, ServingConfig(**SCFG),
                           agents={"tiny": _Greedy(tagent)}, **kw)
    rng = np.random.default_rng(9)
    hog, urgent = _prompt(rng, 8), _prompt(rng, 6)
    seen = {}
    for name, pool, sched in (("ref", ref, s_ref), ("port", port, s_port)):
        states, picks = [], []

        def decide():
            picks.append(sched.control()["tiny"])
            states.append(sched._last["tiny"][0])

        decide()
        pool.submit("tiny", hog, slo_ms=60_000.0, max_new_tokens=24,
                    submit_s=1.0)
        for _ in range(6):
            pool.step()
        decide()
        pool.submit("tiny", urgent, slo_ms=0.001, max_new_tokens=2,
                    submit_s=1.0)
        pool.step()
        assert pool.n_preempted == 1
        decide()
        decide()
        pool.run_until_drained()
        seen[name] = (np.stack(states), picks)
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    assert seen["port"][1] == seen["ref"][1]
    deltas = seen["port"][0][:, 8]
    assert deltas[2] == np.float32(np.log1p(1)) and deltas[3] == 0.0
