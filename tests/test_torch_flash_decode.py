"""The port's B6 (flash decode without the row write) and B8 (in-place KV
row write) against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (their Pallas kernels in
interpret mode, as the JAX tests run them) and the port's counterparts (their
plain versions: the tensors lie on the CPU). Tolerances: attention within one
bf16 step, 2^-7 |ref| + 1e-3 max|ref| (both round an f32 result to bf16);
written caches bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import flash_decode as jfd
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import kv_write as kw

# S = 3 tiles of 512: a window of 100 makes the TPU grid visit 2 of them
B, HKV, S, D, L = 4, 2, 1536, 64, 2
LENGTHS = [0, 1, 31, S]


def _bf16(a):
    """f32 numpy -> (jax bf16, torch bf16) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, t(j)


def _cache(rng, quantized, layers):
    shape = (layers, B, HKV, S, D)
    if quantized:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, shape[:-1] + (1,)).astype(np.float32)
                  for _ in range(2))
        return (jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs)), tuple(
            torch.from_numpy(a) for a in (k, v, ks, vs))
    (jk, tk), (jv, tv) = (_bf16(rng.standard_normal(shape)) for _ in range(2))
    return (jk, jv, None, None), (tk, tv, None, None)


def _close_bf16(got, want):
    g, w = f32(got), f32(want)
    assert np.isfinite(g).all()
    tol = 2.0 ** -7 * np.abs(w) + 1e-3 * np.abs(w).max()
    assert (np.abs(g - w) <= tol).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("rep", [1, 2, 6])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("indexed", [True, False])
def test_flash_decode_attention_matches_jax(indexed, quantized, rep, window):
    """Both forms, rows of length 0 (the mean of V over the tiles the TPU grid
    visits), 1, 31 and S, with and without a window that skips tiles."""
    rng = np.random.default_rng(rep + 10 * quantized + (window or 0))
    jq, tq = _bf16(rng.standard_normal((B, 1, HKV * rep, D)))
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(rng, quantized, L if indexed else 1)
    lengths = np.asarray(LENGTHS, np.int32)
    if indexed:
        want = jfd.flash_decode_attention_indexed(jq, jk, jv, jks, jvs, jnp.int32(1),
                                                  jnp.asarray(lengths), window=window)
        got = fd.flash_decode_attention_indexed(tq, tk, tv, tks, tvs, 1,
                                                torch.from_numpy(lengths), window=window)
    else:
        one = lambda a: None if a is None else a[0]
        want = jfd.flash_decode_attention(jq, one(jk), one(jv), one(jks), one(jvs),
                                          jnp.asarray(lengths), window=window)
        got = fd.flash_decode_attention(tq, one(tk), one(tv), one(tks), one(tvs),
                                        torch.from_numpy(lengths), window=window)
    assert got.shape == (B, 1, HKV * rep, D) and got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_decode_length_zero_is_the_mean_of_visited_values(window):
    """A row with no key in range: JAX's masked logits all tie, so it returns
    the mean of V over the keys of every tile its grid visits (all S without
    a window; the first two tiles of 512 with a window of 100)."""
    rng = np.random.default_rng(0)
    _, tq = _bf16(rng.standard_normal((B, 1, HKV, D)))
    _, (tk, tv, _, _) = _cache(rng, False, 1)
    got = fd.flash_decode_attention(tq, tk[0], tv[0], None, None,
                                    torch.tensor([0, 5, 0, 9], dtype=torch.int32), window=window)
    visited = S if window is None else 1024
    mean = tv[0, 0, :, :visited].float().mean(dim=1)  # [HKV, D]
    _close_bf16(got[0, 0].reshape(HKV, D), mean.to(torch.bfloat16))
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_kv_write_inplace_matches_jax(dtype):
    rng = np.random.default_rng(1)
    shape = (3, B, HKV, 64, D)
    if dtype == "int8":
        cache, new = (rng.integers(-127, 128, s).astype(np.int8) for s in (shape, (B, HKV, 1, D)))
        jc, jn, tc, tn = jnp.asarray(cache), jnp.asarray(new), torch.from_numpy(cache.copy()), \
            torch.from_numpy(new)
    else:
        cache, new = rng.standard_normal(shape), rng.standard_normal((B, HKV, 1, D))
        jc, jn = jnp.asarray(cache, dtype), jnp.asarray(new, dtype)
        tc, tn = t(jc), t(jn)
    offsets = np.asarray([0, 31, 32, 63], np.int32)
    want = np.asarray(jfd.kv_write_inplace(jc, jn, jnp.int32(1), jnp.asarray(offsets)))
    got = kw.kv_write_inplace(tc, tn, 1, torch.from_numpy(offsets))
    assert got is tc
    np.testing.assert_array_equal(f32(got), want.astype(np.float32))
    assert not np.array_equal(f32(got), np.asarray(cache, np.float32))


def test_kv_write4_inplace_matches_jax():
    rng = np.random.default_rng(2)
    shape = (3, B, HKV, 64, D)
    caches = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)] + [
        rng.uniform(0.005, 0.03, shape[:-1] + (1,)).astype(np.float32) for _ in range(2)]
    news = [rng.integers(-127, 128, (B, HKV, 1, D)).astype(np.int8) for _ in range(2)] + [
        rng.uniform(0.005, 0.03, (B, HKV, 1, 1)).astype(np.float32) for _ in range(2)]
    offsets = np.asarray([5, 0, 63, 40], np.int32)
    want = jfd.kv_write4_inplace(*[jnp.asarray(a) for a in caches + news], jnp.int32(2),
                                 jnp.asarray(offsets))
    tcs = [torch.from_numpy(a.copy()) for a in caches]
    got = kw.kv_write4_inplace(*tcs, *[torch.from_numpy(a) for a in news], 2,
                               torch.from_numpy(offsets))
    for g, tc, w in zip(got, tcs, want):
        assert g is tc
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kv_write_skips_rows_outside_the_cache():
    """An offset outside [0, S) writes nothing (the kernel reads no offset
    back to the host); the other rows are written."""
    cache = torch.zeros((2, 3, 2, 8, 4))
    new = torch.ones((3, 2, 1, 4))
    kw.kv_write_inplace(cache, new, 0, torch.tensor([-1, 8, 3], dtype=torch.int32))
    assert cache[0, :2].abs().sum() == 0 and cache[1].abs().sum() == 0
    assert torch.equal(cache[0, 2, :, 3], torch.ones((2, 4)))
    assert cache[0, 2].sum() == 8
