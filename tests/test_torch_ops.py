"""Parity of the PyTorch port's ops with aqlm_tpu on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the JAX tests run them) and the port's counterpart (its
plain version: the tensors lie on the CPU). Tolerances: f32 outputs
rtol = atol = 2e-3 (as tests/test_fuse.py); bf16 outputs one bf16 step
(rtol 8e-3), because two f32 results a few ulp apart may round to
neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, t

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.ops import dequant as jdq
from aqlm_tpu.ops import flash_decode as jfd
from aqlm_tpu.ops import gather_prefill as jgp
from aqlm_tpu.ops import lut_gemv as jlg
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.ops.runtime import quantized_matmul as j_quantized_matmul
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops import dequant as dq
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import lut_gemv as lg
from aqlm_tpu_torch.models.stacked import stack_layer_params
from aqlm_tpu_torch.ops.runtime import (
    IndexedQuantizedLinear,
    QuantizedLinear,
    quantized_matmul,
    quantized_matmul_indexed,
)

G = 8


def _bf16(a):
    """numpy f32 -> (jnp bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, t(j)


def _codes_inputs(rng, L, nt, kig, tn, P, K=2):
    codes = rng.integers(0, 256, (L, nt, kig, tn), dtype=np.uint8)
    cb = rng.standard_normal((L, P, K, 256, G)).astype(np.float32) / 4
    scales = rng.uniform(0.5, 1.5, (L, nt * tn)).astype(np.float32)
    return codes, cb, scales


@pytest.mark.parametrize("out_f", [128, 512, 1024])
def test_tile_codes_matches_jax_and_round_trips(out_f):
    rng = np.random.default_rng(0)
    codes_t = rng.integers(0, 256, (2, 16, out_f), dtype=np.uint8)
    got = lg.tile_codes(torch.from_numpy(codes_t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlg.tile_codes(jnp.asarray(codes_t))))
    np.testing.assert_array_equal(lg.untile_codes(got, 2).numpy(), codes_t)


@pytest.mark.parametrize("scheme_name,og,group_scales", [
    ("2x8g8", 1, False), ("1x16g8", 1, False), ("2x8g8", 2, True),
])
def test_dequantize_weight_matches_jax_exactly(scheme_name, og, group_scales):
    base = JScheme.parse(scheme_name)
    js = JScheme(base.num_codebooks, base.nbits_per_codebook, base.in_group_size, og)
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(3), js, 64, 128, with_bias=True)
    if group_scales:
        rng = np.random.default_rng(1)
        w = jdq.AqlmWeight(codes=w.codes, codebooks=w.codebooks,
                           scales=jnp.asarray(rng.uniform(0.5, 1.5, w.codes.shape[:2]), jnp.float32),
                           bias=w.bias, scheme=js)
    ps = AqlmScheme(js.num_codebooks, js.nbits_per_codebook, js.in_group_size, og)
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales),
                       bias=t(w.bias), scheme=ps)
    want = np.asarray(jdq.dequantize_weight(w, impl="xla"))
    np.testing.assert_array_equal(dq.dequantize_weight(pw).numpy(), want)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    assert_close(dq.aqlm_matmul_reference(torch.from_numpy(x), pw),
                 jdq.aqlm_matmul_reference(jnp.asarray(x), w))


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("variant", ["tiled", "indexed", "grouped"])
def test_lut_gemv_matches_jax(variant, batch):
    rng = np.random.default_rng(10 + batch)
    IN, tn = 128, 128
    sizes = (256, 128, 128) if variant == "grouped" else (256,)
    nt, kig, L = sum(sizes) // tn, IN // G * 2, 2
    codes, cb, scales = _codes_inputs(rng, L, nt, kig, tn, len(sizes))
    x = rng.standard_normal((batch, IN)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jcb, tcb = _bf16(cb)
    if variant == "tiled":
        want = jlg.lut_gemv_kx8_tiled(jx, jnp.asarray(codes[0]), jcb[0, 0], jnp.asarray(scales[0]),
                                      group=G)
        got = lg.lut_gemv_kx8_tiled(tx, t(codes[0]), tcb[0, 0], t(scales[0]), group=G)
    elif variant == "indexed":
        want = jlg.lut_gemv_kx8_indexed(jx, jnp.asarray(codes), jcb[:, 0], jnp.asarray(scales), 1,
                                        group=G)
        got = lg.lut_gemv_kx8_indexed(tx, t(codes), tcb[:, 0], t(scales), 1, group=G)
    else:
        want = jlg.lut_gemv_kx8_grouped_indexed(jx, jnp.asarray(codes), jcb, jnp.asarray(scales),
                                                sizes, 1, group=G)
        got = lg.lut_gemv_kx8_grouped_indexed(tx, t(codes), tcb, t(scales), sizes, 1, group=G)
    assert got.dtype == torch.float32 and got.shape == (batch, sum(sizes))
    assert_close(got, want)


@pytest.mark.parametrize("variant", ["plain", "indexed", "grouped"])
def test_gather_prefill_matches_jax(variant):
    rng = np.random.default_rng(20)
    IN, tn, T = 128, 128, 13  # T is not a multiple of 8 (the JAX path pads)
    sizes = (128, 256) if variant == "grouped" else (256,)
    nt, kig, L = sum(sizes) // tn, IN // G * 2, 2
    codes, cb, scales = _codes_inputs(rng, L, nt, kig, tn, len(sizes))
    x = rng.standard_normal((T, IN)).astype(np.float32)
    bias = rng.standard_normal((L, sum(sizes))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jcb, tcb = _bf16(cb)
    if variant == "plain":
        want = jgp.gather_prefill_matmul(jx, jnp.asarray(codes[0]), jcb[0, 0], jnp.asarray(scales[0]),
                                         jnp.asarray(bias[0]), group=G)
        got = gp.gather_prefill_matmul(tx, t(codes[0]), tcb[0, 0], t(scales[0]), t(bias[0]), group=G)
    elif variant == "indexed":
        want = jgp.gather_prefill_matmul_indexed(jx, jnp.asarray(codes), jcb[:, 0],
                                                 jnp.asarray(scales), 1, group=G)
        got = gp.gather_prefill_matmul_indexed(tx, t(codes), tcb[:, 0], t(scales), 1, group=G)
    else:
        want = jgp.gather_prefill_matmul_grouped_indexed(jx, jnp.asarray(codes), jcb,
                                                         jnp.asarray(scales), sizes, 0, group=G)
        got = gp.gather_prefill_matmul_grouped_indexed(tx, t(codes), tcb, t(scales), sizes, 0,
                                                       group=G)
    assert got.shape == (T, sum(sizes))
    assert_close(got, want)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("quantized", [True, False])
def test_flash_decode_write_attention_matches_jax(quantized, window):
    rng = np.random.default_rng(30)
    L, B, HQ, HKV, S, D = 2, 3, 4, 2, 128, 64
    offsets = np.array([0, 32, 127], np.int32)  # a first row, a tile edge, the last row
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    if quantized:
        cache = [rng.integers(-127, 128, (L, B, HKV, S, D), dtype=np.int8) for _ in range(2)]
        scales = [rng.uniform(0.001, 0.02, (L, B, HKV, S, 1)).astype(np.float32) for _ in range(2)]
        new = [rng.integers(-127, 128, (B, 1, HKV, D), dtype=np.int8) for _ in range(2)]
        new_s = [rng.uniform(0.001, 0.02, (B, 1, HKV, 1)).astype(np.float32) for _ in range(2)]
        jc, tc = [jnp.asarray(c) for c in cache], [torch.from_numpy(c.copy()) for c in cache]
        js, ts = [jnp.asarray(s) for s in scales], [torch.from_numpy(s.copy()) for s in scales]
        jn, tn_ = [jnp.asarray(n) for n in new], [torch.from_numpy(n) for n in new]
        jns, tns = [jnp.asarray(s) for s in new_s], [torch.from_numpy(s) for s in new_s]
    else:
        cache = [rng.standard_normal((L, B, HKV, S, D)).astype(np.float32) for _ in range(2)]
        new = [rng.standard_normal((B, 1, HKV, D)).astype(np.float32) for _ in range(2)]
        pairs = [_bf16(c) for c in cache]
        jc, tc = [p[0] for p in pairs], [p[1].clone() for p in pairs]
        js, ts, jns, tns = [None, None], [None, None], [None, None], [None, None]
        jn, tn_ = [jnp.asarray(n) for n in new], [torch.from_numpy(n) for n in new]
    want = jfd.flash_decode_write_attention_indexed(
        jnp.asarray(q), jn[0], jn[1], jc[0], jc[1], js[0], js[1], 1, jnp.asarray(offsets),
        k_scale_new=jns[0], v_scale_new=jns[1], window=window)
    got = fd.flash_decode_write_attention_indexed(
        torch.from_numpy(q), tn_[0], tn_[1], tc[0], tc[1], ts[0], ts[1], 1,
        torch.from_numpy(offsets), k_scale_new=tns[0], v_scale_new=tns[1], window=window)
    assert got[0].dtype == torch.bfloat16 and got[1] is tc[0]  # written in place
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               rtol=8e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):
        if w is not None:
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("mode,scheme,out_f,item", [
    ("codes", "1x16g8", 128, "B1"),
])
def test_unported_modes_raise(mode, scheme, out_f, item):
    gen = torch.Generator().manual_seed(0)
    w = dq.random_aqlm_weight(gen, AqlmScheme.parse(scheme), out_f, 128, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        QuantizedLinear.from_aqlm(w, mode=mode)


@pytest.mark.parametrize("rows", [1, 9])
def test_codes_mode_unaligned_out_features_matches_jax(rows):
    """2x8 codes at OUT=64 (no tiled layout) dispatch to the dequant-matmul
    (B15) at every batch size, stacked too, and agree with aqlm_tpu's
    quantized_matmul on the same weight; f32 activations: rtol = atol = 1e-5
    (only the f32 sum's order differs)."""
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(7), JScheme.parse("2x8g8"), 64, 128, with_bias=True)
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales),
                       bias=t(w.bias), scheme=AqlmScheme.parse("2x8g8"))
    q = QuantizedLinear.from_aqlm(pw, mode="codes")
    assert q.codes_tl is None and q.codes_t.shape == (2, 16, 64)
    x = np.random.default_rng(rows).standard_normal((rows, 128)).astype(np.float32)
    want = np.asarray(j_quantized_matmul(jnp.asarray(x), JQuantizedLinear.from_aqlm(w, mode="codes")))
    np.testing.assert_allclose(quantized_matmul(torch.from_numpy(x), q).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    stacked = stack_layer_params({"layers": [{"p": q}, {"p": q}]})["layers"]["p"]
    np.testing.assert_allclose(
        quantized_matmul_indexed(torch.from_numpy(x), IndexedQuantizedLinear(stacked, 1)).numpy(),
        want, rtol=1e-5, atol=1e-5)


def test_random_aqlm_weight_codes_are_unsigned_and_in_range():
    gen = torch.Generator().manual_seed(0)
    w = dq.random_aqlm_weight(gen, AqlmScheme.parse("2x8g8"), 256, 128, device="cpu")
    assert w.codes.dtype == torch.uint8 and w.codes.shape == (256, 16, 2)
    assert int(w.codes.max()) > 127  # 8-bit codes use the full unsigned range
    assert w.codebooks.shape == (2, 256, 1, 8)
    assert float(w.scales.min()) >= 0.5 and float(w.scales.max()) < 1.5
