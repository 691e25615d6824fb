"""The split-KV arithmetic of the port's chunked flash-decode kernels (K3 and
B6 at head counts other than 1/2/4/8 per kv head) against aqlm_tpu on the
CPU.

The plain versions cut the keys into splits of whole 64-key tiles, take each
split's softmax state (m, l, acc) and merge the states in split order, as the
kernels do. At Falcon-7B's decode shape (71 query heads over one kv head,
D=64, an int8 cache of 2048 rows) the merged f32 result is held to the
unsplit one within 1e-5 of its largest magnitude, and to JAX's interpret-mode
kernel (which returns bf16) within that kernel's own rounding, 2^-8 |ref|,
plus 1e-5 of the largest magnitude.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import flash_decode as jfd
from aqlm_tpu_torch.ops import flash_decode as fd

HKV, REP, S, D = 1, 71, 2048, 64
OFFSETS = [0, 511, 512, 1999]
LENGTHS = [0, 1, 2048]


@functools.lru_cache(maxsize=None)
def _case(kind, window):
    """Inputs (numpy) and JAX's output for one kind ("write": K3 at OFFSETS,
    "attend": B6 at LENGTHS) and window."""
    rng = np.random.default_rng(7 + (window or 0) + (kind == "write"))
    b = len(OFFSETS if kind == "write" else LENGTHS)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, 1, HKV * REP, D)), jnp.bfloat16))
    shape = (2, b, HKV, S, D)
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, shape[:-1] + (1,)).astype(np.float32) for _ in range(2))
    nk, nv = (rng.integers(-127, 128, (b, 1, HKV, D)).astype(np.int8) for _ in range(2))
    nks, nvs = (rng.uniform(0.005, 0.03, (b, 1, HKV, 1)).astype(np.float32) for _ in range(2))
    if kind == "write":
        want = jfd.flash_decode_write_attention_indexed(
            jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(ks), jnp.asarray(vs), 1, jnp.asarray(OFFSETS, jnp.int32),
            k_scale_new=jnp.asarray(nks), v_scale_new=jnp.asarray(nvs), window=window)[0]
    else:
        want = jfd.flash_decode_attention_indexed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
            jnp.int32(1), jnp.asarray(LENGTHS, jnp.int32), window=window)
    return (q, k, v, ks, vs, nk, nv, nks, nvs), f32(want).reshape(b, HKV, REP, D)


def _port(kind, window, splits, inputs):
    """The port's plain version at ``splits``, f32 [B, Hkv, rep, D]."""
    k, v, ks, vs, nk, nv, nks, nvs = (torch.from_numpy(np.array(a)) for a in inputs[1:])
    b = k.shape[1]
    q_hm = t(jnp.asarray(inputs[0])).reshape(b, HKV, REP, D)
    if kind == "write":
        return fd.plain(q_hm, nk[:, 0], nv[:, 0], nks[:, 0, :, 0], nvs[:, 0, :, 0], k[1], v[1],
                        ks[1], vs[1], torch.tensor(OFFSETS, dtype=torch.int32), D ** -0.5, window,
                        splits=splits, out_dtype=torch.float32)
    return fd.plain_attend(q_hm, k[1], v[1], ks[1], vs[1], torch.tensor(LENGTHS, dtype=torch.int32),
                           D ** -0.5, window, splits=splits, out_dtype=torch.float32)


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("kind", ["write", "attend"])
def test_split_plain_matches_jax(kind, window, splits):
    """K3 at offsets 0/511/512/1999 and B6 at lengths 0 (the mean of V over
    the visited tiles), 1 and 2048, window none and 256, split 1, 3 and 16
    ways: the merge in split order equals the unsplit softmax and JAX's."""
    inputs, want = _case(kind, window)
    got = _port(kind, window, splits, inputs).numpy()
    one = _port(kind, window, 1, inputs).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - one).max() <= 1e-5 * np.abs(one).max()
    tol = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


def test_merge_partials_skips_empty_splits_in_order():
    """Empty splits (l = 0, m = -inf) contribute nothing; the merge of
    split states equals one softmax over all keys."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((1, 1, 3, 256)).astype(np.float32))
    logits[..., 64:128] = -torch.inf  # a split none of whose keys attend
    v = torch.from_numpy(rng.standard_normal((1, 1, 256, 8)).astype(np.float32))
    m, l, acc = fd.split_partials(logits, v, 64)
    assert torch.isneginf(m[..., 1]).all() and (l[..., 1] == 0).all()
    want = torch.softmax(logits, dim=-1) @ v
    assert torch.allclose(fd.merge_partials(m, l, acc), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("splits", [None, 1, 3, 16, 32])
def test_split_plan_covers_the_cache_in_whole_tiles(splits):
    """Keys a split are whole 64-key tiles, the splits cover S with none
    empty; by default Falcon's decode shape fills at least 64 blocks."""
    kps, z = fd.split_plan(4, HKV, REP, S, splits)
    assert kps % fd.SPLIT_TILE == 0 and (z - 1) * kps < S <= z * kps
    if splits is None:
        assert 4 * HKV * z >= 64
    else:
        assert z <= splits
