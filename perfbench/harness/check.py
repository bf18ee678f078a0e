"""Deciding ``correct``: the served tokens of a sample of finished
requests against the plain reference, and the look for JAX.

For each sampled request the reference runs once over its padded prompt
and its served tokens (the program left-pads a prompt with token 0 to its
bucket, and those positions are attended). At each position that served
a token, the gap is the reference's best logit less the reference's
logit of the served token: 0 where the program chose the reference's
argmax, and above the rounding of near ties only where it chose another
token. The number compared is the widest gap over every served token of
the sample. A control reads, at the same positions, the gap of the token
that a lower-precision reference puts first.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference.model import logits
from perfbench.traffic.generator import padded_len

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def sample(results: Dict[int, object], seed: int, tokens: int,
           max_requests: int) -> List[int]:
    """Request ids of finished requests drawn from ``seed``: the one that
    served the most tokens, then others in a seeded order until
    ``tokens`` served tokens or ``max_requests`` requests."""
    done = sorted(rid for rid, r in results.items() if len(r.tokens))
    if not done:
        return []
    longest = max(done, key=lambda rid: len(results[rid].tokens))
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 77]))
    picked, total = [longest], len(results[longest].tokens)
    for rid in rng.permutation([r for r in done if r != longest]):
        if total >= tokens or len(picked) >= max_requests:
            break
        picked.append(int(rid))
        total += len(results[int(rid)].tokens)
    return picked


def sequence(prompt: np.ndarray, served: np.ndarray):
    """(the padded prompt plus every served token but the last, the
    position of the first served token's logits)."""
    S = padded_len(len(prompt))
    seq = np.zeros(S + len(served) - 1, np.int64)
    seq[S - len(prompt):S] = prompt
    seq[S:] = served[:-1]
    return seq, S - 1


def gaps(cfg: Dict, params: Dict, prompt: np.ndarray, served: np.ndarray,
         device, controls: Sequence[str] = (),
         top: Optional[Dict[int, tuple]] = None) -> Dict[str, float]:
    """Widest gap of the served tokens (``served``) and of each control
    mode's first choices, against the float32 reference. With ``top``
    (position -> the program's own argmax and its logit, from a probe of
    the control runs) also the largest difference between that logit
    and the reference's logit of the same token, and the reference's
    smallest margin between its two best logits."""
    seq, first = sequence(np.asarray(prompt), np.asarray(served))
    toks = torch.as_tensor(seq, device=device)
    ref = logits(cfg, params, toks, first, "fp32")
    rows = torch.arange(ref.shape[0], device=device)
    best = ref.max(-1).values
    want = torch.as_tensor(np.asarray(served, np.int64), device=device)
    out = {"served": float((best - ref[rows, want]).max())}
    for mode in controls:
        pick = logits(cfg, params, toks, first, mode).argmax(-1)
        out[mode] = float((best - ref[rows, pick]).max())
    if top:
        err = [abs(v - float(ref[p - first, i])) for p, (i, v) in top.items()
               if 0 <= p - first < ref.shape[0]]
        out["program_logit_err"] = max(err) if err else 0.0
        two = ref.topk(2, dim=-1).values
        out["min_margin"] = float((two[:, 0] - two[:, 1]).min())
    return out


def widest(cfg: Dict, params: Dict, requests: Dict[int, tuple], device,
           controls: Sequence[str] = ()) -> Dict[str, float]:
    """The widest gap over several requests ({rid: (prompt, served,
    top)}); ``min_margin`` is the smallest."""
    out: Dict[str, float] = {}
    for prompt, served, top in requests.values():
        for k, v in gaps(cfg, params, prompt, served, device, controls,
                         top).items():
            out[k] = min(out.get(k, v), v) if k == "min_margin" \
                else max(out.get(k, 0.0), v)
    return out
