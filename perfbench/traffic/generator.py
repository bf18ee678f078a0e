"""The one traffic generator: every mix is a data file beside this module
(``<mix>.json``) that it reads.

Every seed gets the same work. A run's requests fall into segments
(``preadmit``, ``lead_in``, ``window``, ``tail`` for an open loop;
``preadmit`` and an endless ``queue`` of cycles for a closed one). The n
requests of a segment are the quantiles ``(i + 0.5) / n`` of the mix's
prompt and output length distributions, paired by rank order; its n
inter-arrival gaps are the same quantiles of an exponential at the
segment's rate, scaled to sum to the segment's length. The seed only
orders them (a uniform permutation of the pairs, another of the gaps)
and draws the token ids, so the count, the token totals and the
multiset of gaps of a segment are the same on every seed.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

#: the golden ratio's fractional part: a fixed spread of residual shares
GOLDEN = 0.6180339887498949
#: the program's prompt buckets (padded lengths); a longer prompt is refused
PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 640)


def padded_len(n: int) -> int:
    """The padded length the program prefills for an n-token prompt."""
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds the largest bucket "
                     f"{PROMPT_BUCKETS[-1]}")


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.float64) + 0.5) / n


def lengths(n: int, spec: Dict) -> np.ndarray:
    """n lengths at the quantiles of a log-normal with ``median`` and
    ``sigma``, clipped to ``[min, max]``, ascending."""
    z = np.array([NormalDist().inv_cdf(q) for q in quantiles(n)])
    vals = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def gaps(n: int, seconds: float) -> np.ndarray:
    """n exponential inter-arrival gaps at the quantiles, ascending,
    scaled to sum to ``seconds``."""
    g = -np.log1p(-quantiles(n))
    return g * (seconds / g.sum())



@dataclasses.dataclass
class Request:
    segment: str
    #: seconds after the segment's start at which the request is due
    due: float
    prompt: np.ndarray
    max_new: int


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *salt]))


class Schedule:
    """The requests of one run of a mix, from the seed.

    ``segment(name, n, seconds)`` gives a segment's requests in order;
    ``preadmit(n)`` the population admitted before any arrival, whose
    outputs are the residual lengths ``ceil(u * out)``, u spread over
    (0, 1) by rank; ``queue()`` a closed loop's endless cycles.
    """

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)

    def _pairs(self, n: int, salt: int):
        rng = _rng(self.seed, salt)
        prompts = lengths(n, self.mix["prompt"])
        outs = lengths(n, self.mix["output"])
        order = rng.permutation(n)
        return rng, prompts[order], outs[order]

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.integers(0, self.vocab, size=int(n), dtype=np.int32)

    def segment(self, name: str, n: int, seconds: float,
                salt: int) -> List[Request]:
        rng, prompts, outs = self._pairs(n, salt)
        g = gaps(n, seconds)[rng.permutation(n)]
        due = np.concatenate([[0.0], np.cumsum(g)[:-1]])
        return [Request(name, float(due[i]), self._tokens(rng, prompts[i]),
                        int(outs[i])) for i in range(n)]

    def preadmit(self, n: int) -> List[Request]:
        rng, prompts, outs = self._pairs(n, 1)
        # residual lengths ceil(u * out): u a fixed low-discrepancy
        # sequence over the ranks, so the multiset is the seed's to order
        # only
        ranks = np.argsort(np.argsort(outs, kind="stable"), kind="stable")
        u = np.mod((ranks + 0.5) * GOLDEN, 1.0)
        resid = np.maximum(1, np.ceil(u * outs)).astype(np.int64)
        return [Request("preadmit", 0.0, self._tokens(rng, prompts[i]),
                        int(resid[i])) for i in range(n)]

    def queue(self) -> Iterator[Request]:
        """A closed loop's requests: cycles of ``cycle`` requests, each a
        fresh permutation of the same multiset."""
        n = int(self.mix["cycle"])
        c = 0
        while True:
            rng, prompts, outs = self._pairs(n, 1000 + c)
            for i in range(n):
                yield Request("queue", 0.0, self._tokens(rng, prompts[i]),
                              int(outs[i]))
            c += 1

    def open_loop(self, rate: float, lead_in: float, window: float,
                  tail: float) -> Dict[str, List[Request]]:
        """An open loop's segments at ``rate`` requests a second: each
        holds ``round(rate * seconds)`` requests spread over its
        seconds."""
        out = {}
        for salt, (name, secs) in enumerate(
                (("lead_in", lead_in), ("window", window), ("tail", tail)),
                start=2):
            n = max(1, int(round(rate * secs)))
            out[name] = self.segment(name, n, secs, salt)
        return out
