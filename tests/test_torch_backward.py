"""The serving layouts' activation backward against aqlm_tpu on the CPU.

``quantized_matmul``'s gradient in x (the port's ``torch.autograd.Function``,
whose backward runs the plain versions of B10 and B5/B13 on a CPU tensor) is
held against ``jax.grad`` through ``aqlm_tpu``'s ``_serving_matmul`` custom
VJP (its Pallas kernels in interpret mode), in every serving mode (int8 and
int4 at a padded IN, 2x8 codes untiled at OUT 64 and tiled at 128/256, 1x16
codes) and in reference mode (differentiable on both sides), at rows 1, 8
and 33, bf16 and f32 x, on the same numpy inputs and cotangent.

Tolerance: one bf16 step (rtol 2^-7, atol 1e-3 of the largest |dx|): both
sides sum an f32 product in another order and round it once to bf16 (int8,
and every mode at bf16 x); at f32 x only the sum order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t, to_numpy_tree

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.ops.dequant import random_aqlm_weight as j_random_aqlm_weight
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.ops.runtime import quantized_matmul as j_quantized_matmul
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.ops.runtime import quantized_matmul

# mode -> (runtime mode, scheme, in_features): int8 and int4 at a padded IN
MODES = {"int8": ("int8", "2x8g8", 1152), "int4": ("int4", "2x8g8", 1152),
         "codes": ("codes", "2x8g8", 128), "codes_1x16": ("codes", "1x16g8", 128),
         "reference": ("reference", "2x8g8", 128)}


def qlin_pair(mode, out_f, seed=0):
    """The same QuantizedLinear in both packages (JAX's carried across)."""
    rt_mode, scheme, in_f = MODES[mode]
    w = j_random_aqlm_weight(jax.random.PRNGKey(seed), JScheme.parse(scheme), out_f, in_f)
    jq = JQuantizedLinear.from_aqlm(w, mode=rt_mode)
    return jq, params_from_numpy(to_numpy_tree(jq), device="cpu"), in_f


def grad_pair(jq, q, x_np, gy_np, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jx = jnp.asarray(x_np, jdt)
    jgy = jnp.asarray(gy_np)
    want = jax.grad(lambda x: jnp.sum(j_quantized_matmul(x, jq).astype(jnp.float32) * jgy))(jx)
    x = t(jx).clone().requires_grad_(True)
    y = quantized_matmul(x, q)
    (y.float() * torch.from_numpy(gy_np)).sum().backward()
    return x.grad, want


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 8, 33])
@pytest.mark.parametrize("out_f", [64, 128, 256])
@pytest.mark.parametrize("mode", list(MODES))
def test_activation_grad_matches_jax(mode, out_f, rows, dtype):
    jq, q, in_f = qlin_pair(mode, out_f)
    if mode == "codes":  # both codes layouts are crossed
        assert (q.codes_t is not None) == (out_f % 128 != 0)
    rng = np.random.default_rng(out_f * 100 + rows)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    gy = rng.standard_normal((rows, out_f)).astype(np.float32)
    got, want = grad_pair(jq, q, x, gy, dtype)
    assert got.shape == (rows, in_f)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_weights_get_no_gradient(mode):
    """Only x is differentiated: the frozen layout's float tensors stay without a grad."""
    _, q, in_f = qlin_pair(mode, 128)
    for name in q.data_fields:
        v = getattr(q, name)
        if v is not None and v.is_floating_point():
            v.requires_grad_(True)
    x = torch.randn(3, in_f, dtype=torch.bfloat16, requires_grad=True)
    quantized_matmul(x, q).float().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    if mode != "reference":  # reference mode trains its codebooks and scales (calibration)
        assert all(getattr(q, n) is None or getattr(q, n).grad is None for n in q.data_fields)


def test_batched_leading_dims_and_no_grad():
    """[B, T, IN] activations; under no_grad the forward is the same dispatch."""
    jq, q, in_f = qlin_pair("int8", 256)
    x = torch.randn(2, 5, in_f, dtype=torch.bfloat16, requires_grad=True)
    y = quantized_matmul(x, q)
    y.float().sum().backward()
    assert x.grad.shape == (2, 5, in_f)
    with torch.no_grad():
        y2 = quantized_matmul(x, q)
    assert torch.equal(y, y2) and not y2.requires_grad
