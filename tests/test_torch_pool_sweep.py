"""The pool's rate sweep (``repro_torch.launch.pool_sweep``) on the CPU:
the busy-instance shares on a hand-made timeline, and the smoke grid
through ``serve_pool`` at reduced width, whose lines must account for
every issued request."""
import numpy as np
import pytest
import torch

from repro_torch.launch import pool_sweep
from repro_torch.serving.runtime import PoolResult


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _res(inst, admit, finish, model="m", rejected=False):
    return PoolResult(0, model, inst, np.zeros(3, np.int32), admit, admit,
                      finish, 1000.0, rejected=rejected)


def test_busy_shares_count_instances_holding_sequences():
    """Instance 0 holds sequences over [0, 2) s (two overlapping ones),
    instance 1 over [1, 1.5) s; a rejection holds nothing. Of the 2 s
    with anything held, 0.5 s has two instances busy."""
    res = [_res(0, 0.0, 1.2), _res(0, 0.5, 2.0), _res(1, 1.0, 1.5),
           _res(-1, 0.2, 0.2, rejected=True)]
    shares = pool_sweep.busy_shares(res, duration_s=4.0)
    assert shares == pytest.approx({1: 0.75, 2: 0.25}, abs=0.01)
    # the same instance id under another model is another instance
    shares = pool_sweep.busy_shares(res + [_res(1, 0.0, 2.0, model="n")],
                                    duration_s=4.0)
    assert shares == pytest.approx({2: 0.75, 3: 0.25}, abs=0.01)
    assert pool_sweep.busy_shares([], 1.0) == {}


def test_smoke_grid_serves_and_accounts_for_every_request(capsys):
    """Both pools of the smoke grid serve through serve_pool on the CPU;
    each line's issued requests are served, rejected or unfinished, and
    the busy shares sum to one."""
    lines = pool_sweep.run(pool_sweep.SMOKE, device="cpu", reduced=True)
    assert [ln["pool"] for ln in lines] == ["paged", "dense"]
    assert set(lines[1]["models"]) == {"qwen3-0.6b", "recurrentgemma-2b"}
    for ln in lines:
        assert sum(ln["busy_instance_shares"].values()) == pytest.approx(1.0)
        assert 1.0 <= ln["busy_instances_mean"] <= ln["instances_spawned"]
        for row in ln["models"].values():
            assert row["served"] >= 1
            assert row["issued"] == (row["served"] + row["rejected"]
                                     + row["unfinished"])
            assert row["served_tokens"] >= row["served"]
            assert row["latency_ms_p50"] <= row["latency_ms_p99"]
    assert capsys.readouterr().out.count("sweep {") == 2


def test_prefix_cache_switch_and_rate_filter(capsys):
    """``--prefix-cache`` serves the paged smoke configuration with the
    cache on (its templated prompts then hit) and ``--rps`` keeps only
    the named rates of the grid."""
    pool_sweep.main(["--smoke", "--device", "cpu", "--prefix-cache",
                     "--rps", "4"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("sweep ")]
    assert len(lines) == 1
    import json

    line = json.loads(lines[0][len("sweep "):])
    assert line["pool"] == "paged" and line["prefix_cache"]
    assert line["prefix_hit_rate"] > 0.0
