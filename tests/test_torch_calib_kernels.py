"""B13 and B14, the differentiable dequant of calibration, against aqlm_tpu on the CPU.

The port's plain versions (what a CPU tensor runs) are held against the JAX
Pallas kernels in interpret mode, on the same numpy inputs:

- B13 ``dequantize_onehot``: bit-identical at K <= 2 (both select the exact
  f32 entries, or their bf16 roundings, and add them in codebook order from
  zero); rtol 1e-6 at K 8.
- B14 ``cb_grad_segment``: rtol/atol 1e-5 at the four shapes of
  tests/test_kernels.py (sums in another order). Its bf16 mode rounds the
  data first, as the TPU's single-pass bf16 dot does; JAX's interpret mode
  sums the unrounded data, so the port is held against JAX fed the
  bf16-rounded data (1e-5), and within JAX's own 5e-3 (by norm) of the
  exact sum.
- ``dequantize_weight`` gradients (codebooks and scales; impl "kernel" and
  "xla", out groups 1 and 2, per-channel and per-group scales) against
  ``jax.grad`` through JAX's ``dequantize_weight``: rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.ops import dequant as jdq
from aqlm_tpu.ops import kernels as jk
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops import dequant as dq
from aqlm_tpu_torch.ops import kernels as kn


def _codes_cb(rng, og, ig, K, S, g):
    codes = rng.integers(0, S, (og, ig, K)).astype(np.uint8)
    cb = rng.standard_normal((K, S, g)).astype(np.float32)
    scales = (rng.random(og) + 0.5).astype(np.float32)
    return codes, cb, scales


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("K,S,og,ig,g", [(1, 256, 128, 16, 8), (2, 256, 256, 32, 8),
                                         (2, 16, 128, 8, 4), (8, 256, 128, 8, 8)])
def test_dequantize_onehot_plain_matches_jax(K, S, og, ig, g, precise):
    rng = np.random.default_rng(K * 100 + g)
    codes, cb, scales = _codes_cb(rng, og, ig, K, S, g)
    codes_t = np.ascontiguousarray(codes.transpose(2, 1, 0))  # [K, IG, OUT]
    want = np.asarray(jk.dequantize_onehot(jnp.asarray(codes_t), jnp.asarray(cb),
                                           jnp.asarray(scales), group=g, dtype=jnp.float32,
                                           precise=precise))
    got = kn.dequantize_onehot(torch.from_numpy(codes_t), torch.from_numpy(cb),
                               torch.from_numpy(scales), group=g, dtype=torch.float32,
                               precise=precise).numpy()
    assert got.shape == want.shape == (ig * g, og)
    if K <= 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the unscaled row-major form (what the autograd forward calls) is W, not W^T
    w = kn.dequantize_groups(torch.from_numpy(codes), torch.from_numpy(cb), precise=precise)
    np.testing.assert_allclose(w.numpy() * scales[:, None], got.T, rtol=1e-6, atol=0)


def test_dequantize_onehot_bf16_output_matches_jax():
    rng = np.random.default_rng(7)
    codes, cb, scales = _codes_cb(rng, 128, 16, 2, 256, 8)
    codes_t = np.ascontiguousarray(codes.transpose(2, 1, 0))
    want = jk.dequantize_onehot(jnp.asarray(codes_t), jnp.asarray(cb), jnp.asarray(scales),
                                group=8)  # bf16 selection, bf16 out: the serving default
    got = kn.dequantize_onehot(torch.from_numpy(codes_t), torch.from_numpy(cb),
                               torch.from_numpy(scales), group=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


CB_GRAD_CASES = [(2, 256, 4096, 8), (1, 16, 130, 4), (3, 256, 5000, 8), (2, 128, 4096 * 2 + 64, 8)]


@pytest.mark.parametrize("K,S,G,g", CB_GRAD_CASES)
def test_cb_grad_segment_plain_matches_jax(K, S, G, g):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, S, (G, K)).astype(np.int32)
    data = rng.standard_normal((G, g)).astype(np.float32)
    want = np.asarray(jk._cb_grad_call(jnp.asarray(codes).T, jnp.asarray(data), num_segments=S,
                                       interpret=True))
    got = kn.cb_grad_segment(torch.from_numpy(codes.astype(np.uint8)), torch.from_numpy(data), S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,S,G,g", CB_GRAD_CASES[:2])
def test_cb_grad_segment_bf16_mode(K, S, G, g):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, S, (G, K)).astype(np.int32)
    data = rng.standard_normal((G, g)).astype(np.float32)
    rounded = np.asarray(jnp.asarray(data).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jk._cb_grad_call(jnp.asarray(codes).T, jnp.asarray(rounded),
                                       num_segments=S, interpret=True, precise=False))
    got = kn.cb_grad_segment(torch.from_numpy(codes.astype(np.uint8)), torch.from_numpy(data), S,
                             precise=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = np.asarray(jk._cb_grad_call(jnp.asarray(codes).T, jnp.asarray(data), num_segments=S,
                                        interpret=True))
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 5e-3


def test_cb_grad_segment_takes_uint8_codes_up_to_512_segments():
    """uint8 codes read unsigned (codes above 127 land in their own segment),
    S up to 512 with the segments past 255 left 0; other code types and
    more segments raise."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (300, 2)).astype(np.uint8)
    data = rng.standard_normal((300, 8)).astype(np.float32)
    want = np.asarray(jk._cb_grad_call(jnp.asarray(codes.astype(np.int32)).T, jnp.asarray(data),
                                       num_segments=512, interpret=True))
    got = kn.cb_grad_segment(torch.from_numpy(codes), torch.from_numpy(data), 512).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, 256:].any()
    with pytest.raises(ValueError, match="uint8 codes"):
        kn.cb_grad_segment(torch.from_numpy(codes.astype(np.int16)), torch.from_numpy(data), 256)
    with pytest.raises(ValueError, match="at most 512"):
        kn.cb_grad_segment(torch.from_numpy(codes), torch.from_numpy(data), 513)


def _weights(scheme_name, og_size, per_group, seed):
    rng = np.random.default_rng(seed)
    scheme = AqlmScheme.parse(scheme_name)
    scheme = dataclasses.replace(scheme, out_group_size=og_size)
    out_f, in_f = 64, 128
    OG, IG = out_f // og_size, in_f // scheme.in_group_size
    codes = rng.integers(0, scheme.codebook_size, (OG, IG, scheme.num_codebooks)).astype(np.uint8)
    cb = rng.standard_normal(scheme.codebooks_shape()).astype(np.float32)
    scales = (rng.random((OG, IG) if per_group else (OG,)) + 0.5).astype(np.float32)
    target = rng.standard_normal((out_f, in_f)).astype(np.float32)
    jscheme = dataclasses.replace(JScheme.parse(scheme_name), out_group_size=og_size)
    return scheme, jscheme, codes, cb, scales, target


# the kernel dequant takes out_group_size 1 (JAX asserts it too)
@pytest.mark.parametrize("impl,og_size,per_group", [
    ("kernel", 1, False), ("kernel", 1, True), ("xla", 1, False), ("xla", 1, True),
    ("xla", 2, False)])
def test_dequantize_weight_grads_match_jax(impl, og_size, per_group):
    scheme, jscheme, codes, cb, scales, target = _weights("2x8g8", og_size, per_group, og_size)

    def jloss(cbj, scj):
        w = jdq.AqlmWeight(codes=jnp.asarray(codes), codebooks=cbj, scales=scj, bias=None,
                           scheme=jscheme)
        d = jdq.dequantize_weight(w, impl=impl) - target
        return jnp.sum(d * d * jnp.arange(1, d.shape[1] + 1, dtype=jnp.float32) / d.shape[1])

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cb), jnp.asarray(scales))
    cbt = torch.from_numpy(cb).requires_grad_(True)
    sct = torch.from_numpy(scales).requires_grad_(True)
    w = dq.AqlmWeight(codes=torch.from_numpy(codes), codebooks=cbt, scales=sct, bias=None,
                      scheme=scheme)
    d = dq.dequantize_weight(w, impl=impl) - torch.from_numpy(target)
    loss = (d * d * torch.arange(1, d.shape[1] + 1, dtype=torch.float32) / d.shape[1]).sum()
    got = torch.autograd.grad(loss, [cbt, sct])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_dequantize_weight_impls_agree_and_auto_picks_the_plain_gather_on_cpu():
    scheme, _, codes, cb, scales, _ = _weights("2x8g8", 1, False, 5)
    w = dq.AqlmWeight(codes=torch.from_numpy(codes), codebooks=torch.from_numpy(cb),
                      scales=torch.from_numpy(scales), bias=None, scheme=scheme)
    assert w.shape == (64, 128) and (w.out_features, w.in_features) == (64, 128)
    assert not dq._kernel_dequant_ok(w)  # a CPU tensor: the plain gather
    np.testing.assert_array_equal(dq.dequantize_weight(w, impl="kernel").numpy(),
                                  dq.dequantize_weight(w).numpy())
    with pytest.raises(ValueError, match="impl"):
        dq.dequantize_weight(w, impl="gather16")
