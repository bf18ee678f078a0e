#!/usr/bin/env python3
"""How far fp32 rounding moves a full-width model's logits on the card:
the rank-split forward (tp = 2, both shards on one GPU) against the
unsplit one, beside the unsplit model against itself through other GEMM
shapes (the same sequence in a batch of three) and with its embedding
scaled by 1 + eps * N(0, 1) for eps = 1e-7 and 1e-6 (seeded). One
prefill of each of ``chip_smoke.py``'s first three drain prompts, random
weights from seed 0. A greedy divergence at a logit margin below these
spreads is a tie of the model, not a fault of the split.

    python3 tools/tp_rounding.py [arch ...]

(default: rwkv6-3b qwen3-0.6b recurrentgemma-2b; recurrentgemma-2b has one
KV head, which the mesh refuses, so it has no tp = 2 column). Needs one
CUDA device; run from the root of a checkout.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.launch.mesh import make_tp_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.tp import TPModel  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402


def _last(logits: torch.Tensor) -> torch.Tensor:
    return logits[0, -1]


@torch.no_grad()
def spreads(arch: str, dev: torch.device, n_prompts: int = 3) -> None:
    cfg = get_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    model = build_model(cfg)
    tpm = None
    if cfg.n_kv_heads % 2 == 0 and cfg.n_heads % 2 == 0:
        tpm = TPModel(cfg, make_tp_mesh(2, devices=[dev, dev]))
        shards = tpm.shard_params(params)
    for i, prompt in enumerate(cs._drain_prompts(cfg, 4)[:n_prompts]):
        seq = ContinuousBatchingEngine._padded_seq(prompt)
        toks = torch.from_numpy(seq[None].astype(np.int32)).to(dev)
        one = _last(model.prefill(params, {"tokens": toks})[0])
        top = one.topk(2).values
        row = [f"{arch} prompt {i} (S = {len(seq)}): max |logit| "
               f"{float(one.abs().max()):.3f}, top-2 margin "
               f"{float(top[0] - top[1]):.3e}"]
        if tpm is not None:
            two = _last(tpm.prefill_chunk(
                shards, tpm.init_cache(1, len(seq)),
                {"tokens": toks, "pos": torch.zeros(
                    (1,), dtype=torch.int32, device=dev)})[0])
            row.append(f"tp = 2 vs unsplit "
                       f"{float((two - one).abs().max()):.3e}")
        three = model.prefill(params, {"tokens": toks.repeat(3, 1)})[0]
        row.append(f"batch of 3 vs 1 "
                   f"{float((three[0, -1] - one).abs().max()):.3e}")
        for eps in (1e-7, 1e-6):
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            moved = dict(params)
            moved["embed"] = params["embed"] * (1 + eps * torch.randn(
                params["embed"].shape, generator=gen, device=dev))
            got = _last(model.prefill(moved, {"tokens": toks})[0])
            row.append(f"embed x (1 + {eps:g} N) "
                       f"{float((got - one).abs().max()):.3e}")
        print("; ".join(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_rounding: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.phase_env(torch)
    cs.phase_build()
    for arch in sys.argv[1:] or ("rwkv6-3b", "qwen3-0.6b",
                                 "recurrentgemma-2b"):
        spreads(arch, dev)
        torch.cuda.empty_cache()
    print(f"max |logit difference| over the vocabulary, last position "
          f"[{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
