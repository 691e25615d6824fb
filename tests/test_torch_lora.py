"""LoRA training through frozen quantized backbones, against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (their Pallas kernels in
interpret mode, as the JAX tests run them) and the port's counterparts
(their plain versions: the tensors lie on the CPU):

- ``QuantizedLinear.out_features`` / ``in_features`` in every mode (int8
  and int4 report the padded IN, as JAX does): equal.
- ``dense_weight_t`` in int8, int4, 2x8 codes tiled (B5) and untiled (B13),
  1x16 codes and reference mode: bit-identical (the same f32 operations in
  the same order, one rounding).
- B10 ``int8_matmul_transposed`` and B5 ``gather_dequant_wt``: B5
  bit-identical at K <= 2 (a sum of two f32 values has one order), rtol
  1e-6 at K 3 (before the one rounding, to f32); B10 one bf16 step (rtol
  2^-7, atol 1e-3 of the largest |dx|: the f32 sum runs in another order).
- ``LoraLinear`` through ``apply_linear`` over dense, int8, codes and
  reference bases: one bf16 step at bf16 x (two roundings, y and the delta,
  each of a sum in another order), rtol = atol = 2e-5 at f32 x.
- ``attach_lora`` refuses the int8 and codes layouts, as JAX does;
  ``split_lora`` / ``merge_trainable`` / ``merge_lora`` round trips.

The trainer against JAX's is in ``tests/test_torch_lora_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t, to_numpy_tree

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.common import DenseLinear as JDenseLinear
from aqlm_tpu.models.common import LoraLinear as JLoraLinear
from aqlm_tpu.models.common import apply_linear as j_apply_linear
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.ops import gather_prefill as jgp
from aqlm_tpu.ops import int8_matmul as jim
from aqlm_tpu.ops.dequant import random_aqlm_weight as j_random_aqlm_weight
from aqlm_tpu.ops.lut_gemv import tile_codes as j_tile_codes
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.pv import losses as jlosses
from aqlm_tpu.pv import lora as jlora
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear, LoraLinear, apply_linear
from aqlm_tpu_torch.models.quantize import (
    map_quantized_linears,
    random_quantized_params,
    swap_in_quantized,
)
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops.dequant import random_aqlm_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.pv import (
    attach_lora,
    cross_entropy_loss,
    merge_lora,
    merge_trainable,
    split_lora,
)
from aqlm_tpu_torch.pv.trainer import tree_leaves

TINY = dict(hidden_size=128, intermediate_size=256)
# (mode, scheme, out_features, in_features): every layout, int8/int4 at a padded IN
LAYOUTS = [("int8", "2x8g8", 256, 1152), ("int4", "2x8g8", 256, 1152),
           ("int4", "2x8g8", 64, 200), ("codes", "2x8g8", 256, 128),
           ("codes", "2x8g8", 512, 64), ("codes", "2x8g8", 64, 128),
           ("codes", "1x16g8", 96, 256), ("reference", "2x8g8", 64, 128),
           ("reference", "1x8g8", 128, 64)]


def _pair(mode, scheme, out_f, in_f, seed=0):
    w = j_random_aqlm_weight(jax.random.PRNGKey(seed), JScheme.parse(scheme), out_f, in_f)
    jq = JQuantizedLinear.from_aqlm(w, mode=mode)
    return jq, params_from_numpy(to_numpy_tree(jq), device="cpu")


def _one_step(got, want):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("mode,scheme,out_f,in_f", LAYOUTS)
def test_out_in_features_match_jax(mode, scheme, out_f, in_f):
    jq, q = _pair(mode, scheme, out_f, in_f)
    assert (q.out_features, q.in_features) == (jq.out_features, jq.in_features)
    assert q.out_features == out_f
    if mode == "int8":
        assert q.in_features == im.pad_in_features(in_f) == 2048  # padded, as JAX reports it
    elif mode == "int4":
        assert q.in_features >= in_f
    else:
        assert q.in_features == in_f


def test_down_proj_in_features_is_padded():
    """Llama's down_proj (11008 -> 11264) in int8 and int4, without building it:
    the properties read only the layouts' shapes."""
    s = AqlmScheme.parse("2x8g8")
    q8 = QuantizedLinear(codes=None, codebooks=None, scales=torch.ones(4096), bias=None,
                         scheme=s, mode="int8", w8=torch.empty((4096, 11264), dtype=torch.int8),
                         w8_scale=torch.ones(4096))
    q4 = QuantizedLinear(codes=None, codebooks=None, scales=torch.ones(4096), bias=None,
                         scheme=s, mode="int4", w4=torch.empty((4096, 5632), dtype=torch.uint8),
                         w4_gscale=torch.ones((88, 4096)))
    assert q8.in_features == q4.in_features == 11264 == jim.pad_in_features(11008)
    assert q8.out_features == q4.out_features == 4096
    assert DenseLinear(torch.zeros(3, 5), None).out_features == 3


@pytest.mark.parametrize("mode,scheme,out_f,in_f", LAYOUTS)
def test_dense_weight_t_matches_jax(mode, scheme, out_f, in_f):
    jq, q = _pair(mode, scheme, out_f, in_f)
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = np.asarray(jq.dense_weight_t(jdt)).astype(np.float32)
        got = q.dense_weight_t(dt)
        assert got.dtype == dt and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(f32(got), want)


@pytest.mark.parametrize("g_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 5, 33])
@pytest.mark.parametrize("out_f,in_f", [(256, 1152), (128, 64), (1024, 256)])
def test_int8_matmul_transposed_plain_matches_jax(out_f, in_f, rows, g_dtype):
    rng = np.random.default_rng(out_f + rows)
    in_pad = im.pad_in_features(in_f)
    w8 = rng.integers(-127, 128, (out_f, in_pad), dtype=np.int8)
    w8[:, in_f:] = 0
    scale = (rng.uniform(0.5, 1.5, out_f) / 127).astype(np.float32)
    g = rng.standard_normal((rows, out_f)).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if g_dtype == "bf16" else jnp.float32)
    want = jim.int8_matmul_transposed(jg, jnp.asarray(w8), jnp.asarray(scale))
    got = im.int8_matmul_transposed(t(jg), torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, in_pad) == want.shape
    assert not f32(got)[:, in_f:].any()
    _one_step(got, want)


@pytest.mark.parametrize("K,S,out_f,in_f", [(1, 256, 128, 64), (2, 256, 256, 128),
                                            (2, 64, 512, 64), (3, 256, 128, 32)])
def test_gather_dequant_wt_plain_matches_jax(K, S, out_f, in_f):
    rng = np.random.default_rng(K * S + out_f)
    codes_t = rng.integers(0, S, (K, in_f // 8, out_f)).astype(np.uint8)
    cb = jnp.asarray(rng.standard_normal((K, S, 8)) / 4, jnp.bfloat16)
    scales = (rng.random(out_f) + 0.5).astype(np.float32)
    codes_tl = j_tile_codes(jnp.asarray(codes_t))
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = np.asarray(jgp.gather_dequant_wt(codes_tl, cb, jnp.asarray(scales), dtype=jdt))
        got = gp.gather_dequant_wt(t(codes_tl), t(cb), torch.from_numpy(scales), dtype=dt)
        assert got.dtype == dt and tuple(got.shape) == want.shape == (in_f, out_f)
        if K <= 2:
            np.testing.assert_array_equal(f32(got), want.astype(np.float32))
        else:
            np.testing.assert_allclose(f32(got), want.astype(np.float32), rtol=1e-6 if
                                       dt == torch.float32 else 2.0 ** -8, atol=0)


def _adapters(rng, out_f, in_f, r=4):
    a = (rng.standard_normal((r, in_f)) / np.sqrt(r)).astype(np.float32)
    b = (rng.standard_normal((out_f, r)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("base", ["dense", "int8", "codes", "reference"])
def test_lora_linear_forward_matches_jax(base, x_dtype):
    rng = np.random.default_rng(7)
    out_f, in_f = 128, 256
    if base == "dense":
        wd = (rng.standard_normal((out_f, in_f)) * in_f ** -0.5).astype(np.float32)
        jb = JDenseLinear(weight=jnp.asarray(wd, jnp.bfloat16), bias=None)
    else:
        jb = JQuantizedLinear.from_aqlm(
            j_random_aqlm_weight(jax.random.PRNGKey(3), JScheme.parse("2x8g8"), out_f, in_f),
            mode=base)
    a, b = _adapters(rng, out_f, in_f)
    jl = JLoraLinear(base=jb, lora_a=jnp.asarray(a), lora_b=jnp.asarray(b), scale=16.0 / 4)
    lin = params_from_numpy(to_numpy_tree(jl), device="cpu")
    assert isinstance(lin, LoraLinear) and lin.scale == 4.0 and lin.out_features == out_f
    x = rng.standard_normal((5, in_f)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = j_apply_linear(jx, jl)
    got = apply_linear(t(jx), lin)
    assert got.dtype == t(want).dtype
    if x_dtype == "bf16":
        w = f32(want)
        np.testing.assert_allclose(f32(got), w, rtol=2 * 2.0 ** -7, atol=2e-3 * np.abs(w).max())
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def _tiny(mode, num_layers=2, dtype=jnp.bfloat16):
    cfg = jllama.ModelConfig.tiny(num_layers=num_layers, **TINY)
    jp = j_random_quantized_params(jax.random.PRNGKey(0), cfg, JScheme.parse("2x8g8"), mode=mode,
                                   dtype=dtype)
    return cfg, jp


@pytest.mark.parametrize("mode", ["int8", "codes"])
def test_attach_lora_refuses_serving_layouts_as_jax(mode):
    cfg, jp = _tiny(mode, num_layers=1)
    with pytest.raises(AssertionError):
        jlora.attach_lora(jp, jax.random.PRNGKey(1))
    p = params_from_numpy(to_numpy_tree(jp), device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        attach_lora(p, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("r", [2, 8])
def test_attach_lora_shapes_match_jax(r):
    cfg, jp = _tiny("reference", num_layers=1)
    p = params_from_numpy(to_numpy_tree(jp), device="cpu")
    jw = jlora.attach_lora(jp, jax.random.PRNGKey(1), r=r)
    w = attach_lora(p, torch.Generator().manual_seed(1), r=r)
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        jl, lin = jw["layers"][0][name], w["layers"][0][name]
        assert isinstance(lin, LoraLinear) and lin.scale == jl.scale == 16.0 / r
        assert tuple(lin.lora_a.shape) == jl.lora_a.shape and lin.lora_a.dtype == torch.float32
        assert tuple(lin.lora_b.shape) == jl.lora_b.shape and not lin.lora_b.any()
        assert lin.base is p["layers"][0][name]
    assert not isinstance(w["layers"][0]["gate_proj"], LoraLinear)
    assert p["layers"][0]["q_proj"] is not w["layers"][0]["q_proj"]  # a new tree


def test_zero_init_lora_is_identity():
    cfg, jp = _tiny("reference")
    p = params_from_numpy(to_numpy_tree(jp), device="cpu")
    wrapped = attach_lora(p, torch.Generator().manual_seed(1), r=4)
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    assert torch.equal(llama.forward(p, cfg, ids)[0], llama.forward(wrapped, cfg, ids)[0])


def test_split_lora_and_merge_trainable_round_trip():
    cfg, jp = _tiny("reference")
    p = params_from_numpy(to_numpy_tree(jp), device="cpu")
    wrapped = attach_lora(p, torch.Generator().manual_seed(1), r=2)
    adapters, frozen = split_lora(wrapped)
    leaves = tree_leaves(adapters)
    assert len(leaves) == cfg.num_layers * 4 * 2  # 4 targets x (a, b), as JAX counts
    assert all(x.dtype == torch.float32 for x in leaves)
    fq = frozen["layers"][0]["q_proj"]
    assert fq.lora_a is None and fq.lora_b is None and fq.base.codes is not None
    merged = merge_trainable(adapters, frozen)
    ids = torch.tensor([[1, 2, 3]])
    assert torch.equal(llama.forward(wrapped, cfg, ids)[0], llama.forward(merged, cfg, ids)[0])


def test_merge_lora_dense_matches_jax():
    cfg = jllama.ModelConfig.tiny(num_layers=1)
    jp = jllama.init_random_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    jw = jlora.attach_lora(jp, jax.random.PRNGKey(1), r=4)
    jq = jw["layers"][0]["q_proj"]
    jw["layers"][0]["q_proj"] = dataclasses.replace(
        jq, lora_b=jax.random.normal(jax.random.PRNGKey(2), jq.lora_b.shape) * 0.1)
    w = params_from_numpy(to_numpy_tree(jw), device="cpu")
    jm, m = jlora.merge_lora(jw), merge_lora(w)
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        assert isinstance(m["layers"][0][name], DenseLinear)
        np.testing.assert_allclose(f32(m["layers"][0][name].weight),
                                   f32(jm["layers"][0][name].weight), rtol=1e-6, atol=1e-7)
    ids = torch.tensor([[5, 6, 7, 8]])
    np.testing.assert_allclose(f32(llama.forward(w, cfg, ids)[0]), f32(llama.forward(m, cfg, ids)[0]),
                               atol=2e-5)


def test_merge_lora_keeps_quantized_bases_wrapped():
    cfg, jp = _tiny("int8", num_layers=1)
    p = params_from_numpy(to_numpy_tree(jp), device="cpu")
    p = map_quantized_linears(p, lambda li, name, q: LoraLinear(
        q, torch.zeros(2, 128), torch.zeros(q.out_features, 2), 8.0) if name == "q_proj" else q)
    m = merge_lora(p)
    assert isinstance(m["layers"][0]["q_proj"], LoraLinear)
    assert isinstance(m["layers"][0]["k_proj"], QuantizedLinear)


def test_map_and_swap_quantized_linears():
    cfg = llama.ModelConfig.tiny(num_layers=2)
    s = AqlmScheme.parse("2x8g8")
    p = random_quantized_params(torch.Generator().manual_seed(0), cfg, s, mode="reference",
                                device="cpu")
    seen = []
    map_quantized_linears(p, lambda li, name, q: seen.append((li, name)) or q)
    assert seen == [(li, n) for li in range(2) for n in llama.QUANTIZABLE_PROJS]
    w = random_aqlm_weight(torch.Generator().manual_seed(1), s, 64, 64, dtype=torch.float32,
                           device="cpu")
    swap_in_quantized(p, 1, "q_proj", w, "int8")
    assert p["layers"][1]["q_proj"].mode == "int8" and p["layers"][0]["q_proj"].mode == "reference"


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_loss_matches_jax(with_mask):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7))
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if with_mask else None
    jl = jnp.asarray(logits, jnp.bfloat16)
    want = jlosses.cross_entropy_loss(jl, jnp.asarray(labels),
                                      None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(t(jl), torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
