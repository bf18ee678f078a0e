"""The port's registry and two public properties against the reference.

* ``repro_torch.config.list_archs()`` equals the reference's (the
  reference also registers ``qwen3-0.6b-swa``, a sliding-window variant);
* every arch's full and reduced configs equal the reference's, field by
  field;
* ``ModelInstance.free_capacity`` and
  ``ContinuousBatchingEngine.kv_free_tokens`` read the same on the port
  as on the reference, on a TINY paged and a TINY dense engine, after a
  few admissions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import TINY, make_cont_engine, make_pool
from repro.config import get_config as jax_get_config
from repro.config import get_reduced_config as jax_get_reduced
from repro.config import list_archs as jax_list_archs
from repro_torch.config import (ModelConfig, get_config, get_reduced_config,
                                list_archs)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool

TTINY = ModelConfig(**dataclasses.asdict(TINY))
LAYOUTS = ({"kv_layout": "dense"},
           {"kv_layout": "paged", "block_size": 8, "kv_blocks": 12})


def test_list_archs_is_the_references():
    assert list_archs() == jax_list_archs()
    assert "qwen3-0.6b-swa" in list_archs()


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", jax_list_archs())
def test_configs_match_field_by_field(arch):
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced_config(arch), jax_get_reduced(arch))):
        assert _fields(ours) == _fields(ref)


def test_swa_variant_is_qwen3_with_a_window():
    swa, base = get_config("qwen3-0.6b-swa"), get_config("qwen3-0.6b")
    assert swa.sliding_window == 8192
    assert dataclasses.replace(swa, name=base.name,
                               sliding_window=None) == base


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY.vocab_size, int(rng.integers(3, 20)))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda kw: kw["kv_layout"])
def test_kv_free_tokens_matches_the_reference(layout):
    """Admission headroom read after each step while three requests are
    admitted into three slots and drain: unreserved blocks times the
    block size (paged), free slots times ``cache_len`` (dense)."""
    ref = make_cont_engine(max_slots=3, max_seq=48, **layout)
    ours = ContinuousBatchingEngine(TTINY, max_slots=3, max_seq=48,
                                    device="cpu", **layout)
    reads = {"ref": [], "ours": []}
    for name, eng in (("ref", ref), ("ours", ours)):
        reads[name].append(eng.kv_free_tokens)
        for p in _prompts(4):
            eng.submit(p, max_new_tokens=5)
        while eng.waiting or eng.active_slots:
            eng.step()
            reads[name].append(eng.kv_free_tokens)
    assert reads["ours"] == reads["ref"]
    assert min(reads["ours"]) < reads["ours"][0] == reads["ours"][-1]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda kw: kw["kv_layout"])
def test_free_capacity_matches_the_reference(layout):
    """Each instance's free slots after every pool step while five
    requests are routed over two instances of two slots."""
    kw = {"kv_layout": layout["kv_layout"]}
    if layout["kv_layout"] == "paged":
        kw.update(block_size=8, kv_block_budget=24)
    ref = make_pool(max_instances=2, max_slots=2, max_seq=48, **kw)
    ours = ModelInstancePool({"tiny": TTINY}, max_instances=2, max_slots=2,
                             max_seq=48, device="cpu", **kw)
    reads = {"ref": [], "ours": []}
    for name, pool in (("ref", ref), ("ours", ours)):
        pool.scale_to("tiny", 2)
        for p in _prompts(5, seed=1):
            pool.submit("tiny", p, slo_ms=60_000.0, max_new_tokens=4)
        for _ in range(40):
            pool.step()
            reads[name].append([i.free_capacity for i in pool.live()])
    assert reads["ours"] == reads["ref"]
    assert min(min(r) for r in reads["ours"]) == 0
    assert reads["ours"][-1] == [2, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
