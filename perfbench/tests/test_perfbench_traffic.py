"""Every seed gets the same work: the same requests, the same token
totals and the same multiset of gaps, in another order."""
import json
from pathlib import Path

import numpy as np
import pytest

import perfbench_fixtures  # noqa: F401  (the checkout on sys.path)
from perfbench.traffic.generator import PROMPT_BUCKETS, Schedule, padded_len

ROOT = Path(__file__).resolve().parents[2]
SEEDS = [2 ** 31 + 11 * k for k in range(12)]


def load_mix(name):
    return json.loads((ROOT / "perfbench" / "traffic"
                       / f"{name}.json").read_text())


def _cells(mix):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["traffic"] == mix:
            conf = json.loads((ROOT / "perfbench" / "configs"
                               / f"{w['config']}.json").read_text())
            cell = json.loads((ROOT / "perfbench" / "cells"
                               / f"{w['name']}.json").read_text())
            yield w["name"], conf, cell


def _summary(reqs):
    return {"n": len(reqs),
            "prompt_total": int(sum(len(r.prompt) for r in reqs)),
            "output_total": int(sum(r.max_new for r in reqs)),
            "prompts": sorted(len(r.prompt) for r in reqs),
            "outputs": sorted(r.max_new for r in reqs)}


def _gaps(reqs, seconds):
    """A segment's gaps: the due times' successive differences, with the
    segment's length closing the last."""
    return np.sort(np.diff([r.due for r in reqs] + [seconds]))


#: the open loop at the rates its first cells ran (2.5 and 3.0 requests
#: a second) with their preadmitted populations; no cell runs it now
OPEN_LOOP = [("chat", "chatglm3-6b", 2.5, 45), ("chat", "yi-34b-l15", 3.0, 54)]


@pytest.mark.parametrize("mix_name,config,rate,preadmit", OPEN_LOOP,
                         ids=lambda x: str(x))
def test_open_loop_same_work_every_seed(mix_name, config, rate, preadmit):
    mix = load_mix(mix_name)
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / f"{config}.json").read_text())
    max_seq = PROMPT_BUCKETS[-1] + mix["output"]["max"]
    runs = []
    for seed in SEEDS:
        s = Schedule(mix, seed, conf["vocab_size"])
        segs = s.open_loop(rate, mix["lead_in_s"], 51.0, mix["tail_s"])
        segs["preadmit"] = s.preadmit(preadmit)
        runs.append(segs)
    secs = {"lead_in": mix["lead_in_s"], "window": 51.0,
            "tail": mix["tail_s"]}
    for name in ("preadmit", "lead_in", "window", "tail"):
        first = _summary(runs[0][name])
        orders = set()
        for segs in runs:
            reqs = segs[name]
            assert _summary(reqs) == first, (config, name)
            orders.add(tuple(len(r.prompt) for r in reqs))
            if name in secs:
                np.testing.assert_allclose(
                    _gaps(reqs, secs[name]),
                    _gaps(runs[0][name], secs[name]), rtol=0, atol=1e-9)
            for r in reqs:
                assert padded_len(len(r.prompt)) + r.max_new <= max_seq
                assert r.prompt.min() >= 0 \
                    and r.prompt.max() < conf["vocab_size"]
        assert len(orders) == len(SEEDS), (config, name)
    # the window holds round(rate * 51) requests spread over its 51 s
    w = runs[0]["window"]
    assert len(w) == round(rate * 51.0)
    assert min(r.due for r in w) == 0.0
    assert max(r.due for r in w) < 51.0


def test_chat_lengths_have_the_sources_means():
    """The chat mix's medians are fitted so that its quantile multiset's
    means are LMSYS-Chat-1M's 69.5 prompt and 214.5 response tokens."""
    mix = load_mix("chat")
    reqs = Schedule(mix, 1, 1000).segment("window", 400, 51.0, 2)
    assert abs(np.mean([len(r.prompt) for r in reqs]) - 69.5) < 1.5
    assert abs(np.mean([r.max_new for r in reqs]) - 214.5) < 1.5


@pytest.mark.parametrize("cell,conf,settings", list(_cells("batch")),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_closed_queue_same_work_every_seed(cell, conf, settings):
    mix = load_mix("batch")
    n = settings["engine"]["max_slots"]
    cycle = mix["cycle"]
    firsts = None
    orders = set()
    for seed in SEEDS:
        s = Schedule(mix, seed, conf["vocab_size"])
        q = s.queue()
        cycles = [[next(q) for _ in range(cycle)] for _ in range(3)]
        got = [_summary(s.preadmit(n))] + [_summary(c) for c in cycles]
        if firsts is None:
            firsts = got
        assert got == firsts
        # every cycle is the same multiset
        assert got[1] == got[2] == got[3]
        orders.add(tuple(len(r.prompt) for r in cycles[0]))
        for c in cycles:
            for r in c:
                assert padded_len(len(r.prompt)) + r.max_new \
                    <= settings["engine"]["max_seq"]
    assert len(orders) == len(SEEDS)


@pytest.mark.parametrize("n", [8, 61, 128, 200])
def test_the_seed_order_is_a_uniform_permutation(n):
    """Over many seeds the longest request of a segment lands anywhere in
    it: the order is a plain permutation, not a spreading of ranks."""
    mix = load_mix("chat")
    where = []
    for seed in range(240):
        reqs = Schedule(mix, 2 ** 31 + seed, 1000).segment("w", n, 10.0, 2)
        lens = [len(r.prompt) for r in reqs]
        where.append(lens.index(max(lens)) / max(1, n - 1))
    assert abs(np.mean(where) - 0.5) < 0.08
    assert min(where) < 0.1 and max(where) > 0.9
