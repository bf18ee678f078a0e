"""The port's serving CLI against the reference's, on the CPU, for the
engine flags of preemption, speculation, the prefix cache and its
templated workload, the host tier, the paged pool and push-mode HTTP
serving.

Both CLIs parse the same command line with their serving functions
replaced by recorders: the same outcome follows (the same serving mode
called with the same flags, the same "ignored in round mode" note, or
the same exit code 2 with the same ``ap.error`` message), speculation and
the host tier included, and for every model family. Unrecorded, an
encoder-decoder model in continuous mode raises the reference's error on
both CLIs.
"""
import sys

import pytest

from repro.launch import engine_serve as jax_engine_serve
from repro.launch import serve as jax_cli
from repro_torch.launch import engine_serve
from repro_torch.launch import serve as serve_cli

#: the arguments each serving function's outcome is compared on
KEYS = {
    "serve_round": ("arch",),
    "serve_continuous": ("arch", "kv_layout", "prefix_cache",
                         "shared_prefix_tokens", "spec_k"),
    "serve_pool": ("models", "kv_layout", "preemption", "kv_host_blocks",
                   "preempt_mode", "prefix_cache", "shared_prefix_tokens",
                   "spec_k"),
    "serve_http": ("models", "port", "kv_layout", "backpressure",
                   "max_queue_depth", "max_instances"),
}
NAMES = {"serve_round": ("arch",), "serve_continuous": ("arch",),
         "serve_pool": ("models",), "serve_http": ("models",)}

CASES = {
    "round-preemption": ["--engine", "--preemption"],
    "round-spec-k": ["--engine", "--spec-k", "2"],
    "round-prefix-cache-paged": ["--engine", "--prefix-cache",
                                 "--kv-layout", "paged"],
    "round-token-budget": ["--engine", "--token-budget", "32"],
    "continuous-preemption": ["--engine", "--exec-mode", "continuous",
                              "--preemption"],
    "pool-preemption": ["--engine", "--models", "qwen3-0.6b",
                        "--preemption", "--preempt-mode", "recompute"],
    "pool-paged-host-tier": ["--engine", "--models", "qwen3-0.6b",
                             "--kv-layout", "paged", "--kv-host-blocks",
                             "8", "--preempt-mode", "swap"],
    "pool-host-tier-auto-spec": ["--engine", "--models", "qwen3-0.6b",
                                 "--kv-layout", "paged", "--preemption",
                                 "--kv-host-blocks", "64", "--preempt-mode",
                                 "auto", "--spec-k", "4"],
    "pool-spec-k": ["--engine", "--models", "qwen3-0.6b,recurrentgemma-2b",
                    "--exec-mode", "continuous", "--spec-k", "2"],
    "continuous-spec-k": ["--engine", "--exec-mode", "continuous",
                          "--spec-k", "4"],
    "continuous-spec-k-paged": ["--engine", "--exec-mode", "continuous",
                                "--kv-layout", "paged", "--spec-k", "2",
                                "--token-budget", "16"],
    "continuous-host-tier-paged": ["--engine", "--exec-mode", "continuous",
                                   "--kv-layout", "paged",
                                   "--kv-host-blocks", "8"],
    "http": ["--engine", "--serve-http", "--port", "8907", "--models",
             "qwen3-0.6b", "--max-instances", "1", "--kv-layout", "paged"],
    "http-no-backpressure": ["--engine", "--serve-http", "--port", "0",
                             "--no-backpressure", "--max-queue-depth", "3"],
    "prefix-cache-dense": ["--engine", "--prefix-cache"],
    "http-without-engine": ["--serve-http"],
    "host-tier-dense": ["--engine", "--models", "qwen3-0.6b",
                        "--kv-host-blocks", "8"],
    "swap-without-host-tier": ["--engine", "--models", "qwen3-0.6b",
                               "--preempt-mode", "swap"],
    "continuous-prefix-cache-paged": [
        "--engine", "--exec-mode", "continuous", "--kv-layout", "paged",
        "--prefix-cache", "--shared-prefix-tokens", "32"],
    "pool-pair-paged": ["--engine", "--models",
                        "qwen3-0.6b,recurrentgemma-2b", "--exec-mode",
                        "continuous", "--kv-layout", "paged",
                        "--kv-block-budget", "64"],
    "pool-pair-paged-prefix-cache": [
        "--engine", "--models", "qwen3-0.6b,recurrentgemma-2b",
        "--kv-layout", "paged", "--prefix-cache", "--shared-prefix-tokens",
        "500"],
    # one command line per family: chatglm3, qwen2-vl, seamless, starcoder2,
    # yi
    "round-chatglm3": ["--engine", "--arch", "chatglm3-6b"],
    "continuous-qwen2-vl-paged": ["--engine", "--exec-mode", "continuous",
                                  "--arch", "qwen2-vl-7b", "--kv-layout",
                                  "paged"],
    "round-seamless": ["--engine", "--arch", "seamless-m4t-large-v2"],
    "continuous-starcoder2": ["--engine", "--exec-mode", "continuous",
                              "--arch", "starcoder2-15b", "--token-budget",
                              "32"],
    "continuous-yi-paged-spec-k": ["--engine", "--exec-mode", "continuous",
                                   "--arch", "yi-34b", "--kv-layout",
                                   "paged", "--spec-k", "2"],
    "pool-vision-paged-prefix-cache": [
        "--engine", "--models", "qwen3-0.6b,qwen2-vl-7b", "--kv-layout",
        "paged", "--prefix-cache", "--shared-prefix-tokens", "32"],
}


def _record(monkeypatch, module, calls):
    """Replace ``module``'s serving functions by recorders of their
    keyword arguments (positional ones mapped to their names)."""
    for fn, keys in KEYS.items():
        def rec(*args, _fn=fn, **kw):
            kw.update(zip(NAMES[_fn], args))
            calls.append((_fn, {k: (list(kw[k]) if k == "models"
                                    else kw.get(k)) for k in KEYS[_fn]
                                if k in kw}))
        monkeypatch.setattr(module, fn, rec)


def _outcome(run, capsys):
    """(exit code or None, calls, the notes printed, the error line)."""
    code = None
    try:
        run()
    except SystemExit as e:
        code = e.code
    cap = capsys.readouterr()
    notes = [ln for ln in cap.out.splitlines() if "ignored" in ln
             or "continuous-only" in ln or "per-round cache" in ln]
    err = [ln for ln in cap.err.splitlines() if "error:" in ln]
    return code, notes, [e.split("error:", 1)[1] for e in err]


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_outcome_is_the_references(case, monkeypatch, capsys):
    argv = CASES[case]
    got, want = [], []
    _record(monkeypatch, engine_serve, got)
    _record(monkeypatch, jax_engine_serve, want)
    ours = _outcome(lambda: serve_cli.main(argv + ["--device", "cpu"]),
                    capsys)
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    theirs = _outcome(jax_cli.main, capsys)
    assert ours == theirs
    # the same serving call; the port also passes where it runs
    for (fn, kw), (rfn, rkw) in zip(got, want):
        assert fn == rfn and kw == rkw, (kw, rkw)
    assert len(got) == len(want) == (0 if theirs[0] else 1)


def test_cli_refuses_encoder_decoder_in_continuous_mode(monkeypatch):
    """``--arch seamless-m4t-large-v2 --exec-mode continuous`` reaches the
    continuous engine, which refuses an encoder-decoder model with the
    reference's error on both CLIs."""
    argv = ["--engine", "--exec-mode", "continuous", "--arch",
            "seamless-m4t-large-v2"]
    msg = "continuous batching does not support encoder-decoder"
    with pytest.raises(NotImplementedError, match=msg):
        serve_cli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    with pytest.raises(NotImplementedError, match=msg):
        jax_cli.main()
