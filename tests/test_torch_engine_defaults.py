"""The port's ``ContinuousBatchingEngine`` constructor against the
reference's: every parameter the two share has the same default (the
KV layout defaults to dense on both), and a default-constructed engine of
a recurrent family builds, as the reference's does.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro_torch.config import ModelConfig
from repro_torch.serving.engine import ContinuousBatchingEngine
from conftest import KIND_CFGS


def _defaults(cls):
    return {n: p.default for n, p in
            inspect.signature(cls.__init__).parameters.items()
            if p.default is not inspect.Parameter.empty}


def _torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def test_constructor_defaults_match_the_reference():
    port, ref = _defaults(ContinuousBatchingEngine), _defaults(JaxEngine)
    shared = sorted(set(port) & set(ref))
    assert "kv_layout" in shared and "max_slots" in shared
    assert {n: port[n] for n in shared} == {n: ref[n] for n in shared}
    assert port["kv_layout"] == "dense"


@pytest.mark.parametrize("kind", ["rglru", "rwkv"])
def test_default_engine_builds_for_a_recurrent_family(kind):
    """The default (dense) engine of a recurrent stack builds on the CPU
    and serves a request, as the reference's default engine does."""
    cfg = KIND_CFGS[kind]
    eng = ContinuousBatchingEngine(_torch_cfg(cfg), max_seq=32,
                                   device="cpu")
    ref = JaxEngine(cfg, max_seq=32)
    assert eng.kv_layout == ref.kv_layout == "dense"
    res = eng.run([np.arange(1, 6, dtype=np.int32)], max_new_tokens=2)
    assert len(res) == 1 and len(res[0].tokens) == 2
