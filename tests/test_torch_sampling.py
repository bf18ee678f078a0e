"""Seeded sampling on the port (``sample_tokens`` and
``InferenceEngine.generate(greedy=False)``) on the CPU.

torch's generator cannot reproduce ``jax.random``'s bits, so the port's
draws are held to the reference in distribution, not token for token:
fixed for one seed, different across seeds, and over 4,000 draws their
frequencies match ``softmax(logits)`` within a chi-square bound that the
reference's own draws meet too. Greedy sampling is the reference's argmax,
ties included, and a sampled round keeps the greedy first token.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import TINY
from repro.serving.engine import InferenceEngine as JaxRoundEngine
from repro.serving.engine import sample_tokens as jax_sample_tokens
from repro_torch.config.base import ModelConfig
from repro_torch.serving.engine import InferenceEngine, sample_tokens

#: 7 degrees of freedom (8 categories); the 0.999 quantile of chi-square
#: is 24.32, so a correct sampler exceeds it once in a thousand seeds
CHI2_BOUND = 24.32
N_DRAWS = 4000
LOGITS = np.array([1.5, 0.2, -0.7, 0.9, -2.0, 0.0, 1.1, -0.3], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chi2(draws: np.ndarray, logits: np.ndarray) -> float:
    p = np.exp(logits - logits.max())
    p /= p.sum()
    want = p * len(draws)
    got = np.bincount(draws, minlength=len(logits))
    return float(((got - want) ** 2 / want).sum())


def test_draws_are_fixed_per_seed_and_differ_across_seeds():
    logits = torch.from_numpy(np.tile(LOGITS, (64, 1)))
    a = sample_tokens(logits, greedy=False, seed=5)
    assert a.dtype == np.int32 and a.shape == (64,)
    np.testing.assert_array_equal(a, sample_tokens(logits, greedy=False,
                                                   seed=5))
    assert not np.array_equal(a, sample_tokens(logits, greedy=False,
                                               seed=6))
    assert len(set(a.tolist())) > 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frequencies_match_softmax_like_the_references(seed):
    """4,000 draws (one call over 4,000 rows) against softmax(logits):
    the port's and the reference's statistics both stay under the
    bound."""
    rows = np.tile(LOGITS, (N_DRAWS, 1))
    port = sample_tokens(torch.from_numpy(rows), greedy=False, seed=seed)
    ref = jax_sample_tokens(rows, greedy=False, seed=seed)
    assert _chi2(port, LOGITS) < CHI2_BOUND
    assert _chi2(np.asarray(ref), LOGITS) < CHI2_BOUND


def test_greedy_is_the_references_argmax_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 3, 11)).astype(np.float32)
    logits[0, 0, [2, 7]] = 9.0  # a tie: the first index wins
    got = sample_tokens(torch.from_numpy(logits))
    np.testing.assert_array_equal(got, jax_sample_tokens(logits))
    assert got[0, 0] == 2


def test_sampled_round_keeps_the_greedy_first_token_and_its_seed():
    """A sampled round: the first token is the greedy one (the
    reference's too), the rest repeat for one seed, and the tokens after
    the first are spread the way the logits say (not all greedy)."""
    je = JaxRoundEngine(TINY, seed=1)
    te = InferenceEngine(ModelConfig(**dataclasses.asdict(TINY)),
                         device="cpu")
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    prompts = [np.arange(1, 9, dtype=np.int32), np.full(4, 7, np.int32)]
    greedy = te.generate(prompts, max_new_tokens=12).tokens
    ref_sampled = je.generate(prompts, max_new_tokens=12, greedy=False,
                              seed=0).tokens
    runs = [te.generate(prompts, max_new_tokens=12, greedy=False,
                        seed=s).tokens for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0][:, 0], greedy[:, 0])
    np.testing.assert_array_equal(runs[0][:, 0], ref_sampled[:, 0])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert not np.array_equal(runs[0], greedy)
