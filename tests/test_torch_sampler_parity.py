"""``serve/sampler.filter_logits`` and ``sample_tokens`` against aqlm_tpu's on the CPU.

At top_p near 1 the two filters may mask different tail tokens: the f32
cumulative sums of the sorted probabilities round differently in the two
frameworks, so one may reach top_p a token before the other. A masked tail
token carries at most the probability that separates the two sums' last
bits, so the two sampling distributions (the softmax of each filtered row)
stay within 1e-5 total variation; greedy rows (temperature 0) pick the same
token. Inputs are seeded numpy logits handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqlm_tpu.serve import sampler as jsampler
from aqlm_tpu_torch.serve import sampler as tsampler

B, V = 8, 4096


def _logits(seed, scale):
    """Rows with a long flat tail (many tokens of similar small probability,
    where the two cumulative sums reach 1 at different tokens)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32) * scale
    x[:, :16] += 4.0  # a head of likely tokens
    return x


def _probs(filtered):
    f = np.asarray(filtered, dtype=np.float64)
    e = np.exp(f - f.max(axis=-1, keepdims=True))  # exp(-inf) = 0 at masked entries
    return e / e.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.999, 1.0])
def test_filter_logits_distributions_match_jax(top_p, temperature, top_k):
    for seed, scale in ((0, 0.5), (1, 1.0), (2, 2.0)):
        x = _logits(seed, scale)
        temp = np.full(B, temperature, np.float32)
        tp = np.full(B, top_p, np.float32)
        want = jsampler.filter_logits(jnp.asarray(x), jnp.asarray(temp), jnp.asarray(tp), top_k)
        got = tsampler.filter_logits(torch.from_numpy(x), torch.from_numpy(temp),
                                     torch.from_numpy(tp), top_k)
        tv = 0.5 * np.abs(_probs(want) - _probs(got.numpy())).sum(axis=-1)
        assert tv.max() <= 1e-5, (seed, tv.max())
        # the tokens kept agree but for tail tokens of that size
        kept_j, kept_t = np.isfinite(np.asarray(want)), np.isfinite(got.numpy())
        assert (_probs(want)[kept_j != kept_t] <= 1e-5).all()


@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("top_p", [0.5, 1.0])
def test_greedy_rows_match_jax(top_p, top_k):
    """Rows at temperature 0 take the argmax in both, beside sampled rows."""
    x = _logits(3, 1.0)
    temp = np.array([0.0, 0.7, 0.0, 1.0, 0.0, 0.0, 0.7, 0.0], np.float32)
    tp = np.full(B, top_p, np.float32)
    want = np.asarray(jsampler.sample_tokens(jnp.asarray(x), jax.random.PRNGKey(0),
                                             jnp.asarray(temp), jnp.asarray(tp), top_k))
    got = tsampler.sample_tokens(torch.from_numpy(x), torch.Generator().manual_seed(0),
                                 torch.from_numpy(temp), torch.from_numpy(tp), top_k).numpy()
    greedy = temp == 0
    assert (got[greedy] == want[greedy]).all()
    assert (got[greedy] == x[greedy].argmax(axis=-1)).all()
