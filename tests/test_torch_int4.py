"""The port's int4 (W4A16) serving mode against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (the Pallas int4 kernels
in interpret mode, as the JAX tests run them) and the port's counterparts
(their plain versions: the tensors lie on the CPU). Tolerances: bf16 outputs
one bf16 step (rtol 8e-3, atol 2e-3), f32 outputs rtol = atol = 2e-3; the
packed int4 weights, their group scales and checkpoint arrays are identical;
greedy Engine tokens are identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, f32, run_engine, t, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.io.checkpoint import save_quantized_model
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.common import apply_linear as j_apply_linear
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.ops import dequant as jdq
from aqlm_tpu.ops import int4_matmul as j4
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu.serve import fuse as jfuse
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import apply_linear
from aqlm_tpu_torch.ops import dequant as dq
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig
from aqlm_tpu_torch.serve import fuse

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=8)
OUT, IN = 256, 1152  # IN pads to 2048; OUT != IN_pad/128, so a transposed gscale fails on shape


@functools.cache
def _quantized(seed, out_f, in_f, mse_clip=True):
    """(dense, JAX w4, JAX gscale) of a random dense weight."""
    dense = np.random.default_rng(seed).standard_normal((out_f, in_f)).astype(np.float32)
    w4, gs = j4.quantize_int4(jnp.asarray(dense), mse_clip=mse_clip)
    return dense, np.asarray(w4), np.asarray(gs)


def _int4_inputs(L=1):
    """Stacked JAX-quantized weights [L, OUT, IN_pad/2], scales, bias."""
    packs = [_quantized(10 + i, OUT, IN) for i in range(L)]
    w4 = np.stack([p[1] for p in packs])
    gs = np.stack([p[2] for p in packs])
    bias = np.random.default_rng(L).standard_normal((L, OUT)).astype(np.float32)
    return w4, gs, bias


def _x(rng, rows, dtype):
    x = rng.standard_normal((rows, IN)).astype(np.float32)
    if dtype == "bf16":
        j = jnp.asarray(x, jnp.bfloat16)
        return j, t(j)
    return jnp.asarray(x), torch.from_numpy(x)


def _check(got, want, dtype):
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    if dtype == "bf16":
        np.testing.assert_allclose(f32(got), f32(want), rtol=8e-3, atol=2e-3)
    else:
        assert_close(got, want)


def test_int4_constants_and_padding_match_jax():
    assert i4.GROUP == j4.GROUP and i4.CLIP_CANDIDATES == j4.CLIP_CANDIDATES
    for n in (128, 256, 384, 1024, 1025, 1152, 4096, 11008, 14336):
        assert i4.pad_in_features_int4(n) == j4.pad_in_features_int4(n)


@pytest.mark.parametrize("mse_clip", [True, False])
@pytest.mark.parametrize("in_f", [384, 1152])
def test_quantize_int4_matches_jax_exactly(in_f, mse_clip):
    dense, jw, jg = _quantized(1, OUT, in_f, mse_clip)
    w4, gs = i4.quantize_int4(torch.from_numpy(dense), mse_clip=mse_clip)
    assert w4.dtype == torch.uint8 and w4.shape == (OUT, i4.pad_in_features_int4(in_f) // 2)
    assert gs.dtype == torch.float32 and gs.shape == (i4.pad_in_features_int4(in_f) // 128, OUT)
    np.testing.assert_array_equal(w4.numpy(), jw)
    np.testing.assert_array_equal(gs.numpy(), jg)
    np.testing.assert_array_equal(i4.dequantize_int4(w4, gs).numpy(),
                                  np.asarray(j4.dequantize_int4(jnp.asarray(jw), jnp.asarray(jg))))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_int4_matmul_matches_jax(batch, with_bias, dtype):
    rng = np.random.default_rng(60 + batch)
    w4, gs, bias = _int4_inputs()
    jx, tx = _x(rng, batch, dtype)
    jb, tb = (jnp.asarray(bias[0]), torch.from_numpy(bias[0])) if with_bias else (None, None)
    want = j4.int4_matmul(jx, jnp.asarray(w4[0]), jnp.asarray(gs[0]), jb)
    got = i4.int4_matmul(tx, t(w4[0]), t(gs[0]), tb)
    assert got.shape == (batch, OUT)
    _check(got, want, dtype)


@pytest.mark.parametrize("batch", [3, 16])
def test_int4_matmul_indexed_matches_jax(batch):
    rng = np.random.default_rng(70 + batch)
    w4, gs, bias = _int4_inputs(L=3)
    jx, tx = _x(rng, batch, "bf16")
    want = j4.int4_matmul_indexed(jx[None], jnp.asarray(w4), jnp.asarray(gs), 1, jnp.asarray(bias))
    got = i4.int4_matmul_indexed(tx[None], t(w4), t(gs), 1, t(bias))
    assert got.shape == (1, batch, OUT)
    _check(got, want, "bf16")


def test_int4_nibble_order_one_hot():
    """x = e_c picks column c of the dequantized weight: the low nibble of
    byte j in block i is column 256i + j, the high nibble 256i + 128 + j."""
    _, jw, jg = _quantized(2, OUT, 512)
    cols = [0, 5, 127, 128, 200, 255, 256, 300, 383, 384, 511]
    x = np.zeros((len(cols), 512), np.float32)
    x[np.arange(len(cols)), cols] = 1.0
    got = i4.int4_matmul(torch.from_numpy(x), t(jw), t(jg))
    want = j4.int4_matmul(jnp.asarray(x), jnp.asarray(jw), jnp.asarray(jg))
    oracle = np.asarray(j4.dequantize_int4(jnp.asarray(jw), jnp.asarray(jg)))[:, cols].T
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(np.asarray(want), oracle)
    # block 1's byte 0: low nibble column 256, high nibble column 384
    q = jw[:, 128].astype(np.int32)
    np.testing.assert_array_equal(oracle[cols.index(256)], ((q & 15) - 8).astype(np.float32) * jg[2])
    np.testing.assert_array_equal(oracle[cols.index(384)], ((q >> 4) - 8).astype(np.float32) * jg[3])


@pytest.mark.parametrize("scheme_name,out_f,in_f", [("2x8g8", 256, 1152), ("1x16g8", 128, 256)])
def test_from_aqlm_int4_matches_jax_exactly(scheme_name, out_f, in_f):
    js = JScheme.parse(scheme_name)
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(9), js, out_f, in_f, with_bias=True)
    want = JQuantizedLinear.from_aqlm(w, mode="int4")
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales),
                       bias=t(w.bias), scheme=AqlmScheme.parse(scheme_name))
    got = QuantizedLinear.from_aqlm(pw, mode="int4")
    assert got.mode == "int4" and got.w4.shape == (out_f, i4.pad_in_features_int4(in_f) // 2)
    for f in ("w4", "w4_gscale", "scales", "bias"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    x = np.random.default_rng(8).standard_normal((3, in_f)).astype(np.float32)
    assert_close(apply_linear(torch.from_numpy(x), got), j_apply_linear(jnp.asarray(x), want))


@functools.cache
def _params(dtype=jnp.float32):
    jcfg = jllama.ModelConfig.tiny(**CFG)
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode="int4",
                                           dtype=dtype)


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(f32(got), f32(want))


def test_fuse_projections_int4_matches_jax():
    jcfg, jparams = _params()
    # a bias on q of layer 0: that q/k/v group stays unfused, as in aqlm_tpu
    layer0 = dict(jparams["layers"][0])
    q = layer0["q_proj"]
    layer0["q_proj"] = dataclasses.replace(
        q, bias=jnp.asarray(np.random.default_rng(3).standard_normal(q.w4.shape[0]), jnp.float32))
    jparams = {**jparams, "layers": [layer0] + jparams["layers"][1:]}
    want = jfuse.fuse_projections(jparams, jcfg)
    got = fuse.fuse_projections(_port(jparams), llama.ModelConfig.tiny(**CFG))
    assert "qkv_proj" not in got["layers"][0] and "q_proj" in got["layers"][0]
    assert "qkv_proj" in got["layers"][1]
    x = np.random.default_rng(4).standard_normal((2, 3, CFG["hidden_size"])).astype(np.float32)
    for gl, wl in zip(got["layers"], want["layers"]):
        assert set(gl) == set(wl) and "gateup_proj" in gl
        for name in set(gl) & {"qkv_proj", "gateup_proj", "q_proj"}:
            g, w = gl[name], wl[name]
            assert g.mode == "int4"
            for f in ("w4", "w4_gscale", "scales", "bias"):
                if getattr(w, f) is None:
                    assert getattr(g, f) is None
                else:
                    _same(getattr(g, f), getattr(w, f))
            assert_close(apply_linear(torch.from_numpy(x), g), j_apply_linear(jnp.asarray(x), w))
    with pytest.raises(NotImplementedError, match="A14"):
        fuse.fuse_projections(_port(jparams), llama.ModelConfig.tiny(**CFG), tp=2)


def test_int4_linear_from_dense_matches_jax():
    dense, _, _ = _quantized(5, OUT, 384)
    bias = np.random.default_rng(5).standard_normal(OUT).astype(np.float32)
    want = jfuse.int4_linear_from_dense(jnp.asarray(dense), jnp.asarray(bias))
    got = fuse.int4_linear_from_dense(torch.from_numpy(dense), torch.from_numpy(bias))
    assert got.mode == "int4"
    for f in ("w4", "w4_gscale", "scales", "bias"):
        _same(getattr(got, f), getattr(want, f))


def test_load_quantized_model_reads_jax_int4_checkpoint(tmp_path):
    jcfg, jparams = _params(jnp.bfloat16)
    save_quantized_model(str(tmp_path), jparams, jcfg)
    params, cfg = load_quantized_model(str(tmp_path), device="cpu")
    assert cfg == llama.ModelConfig.tiny(**CFG)
    want = to_numpy_tree(jparams)
    for layer, ref in zip(params["layers"], want["layers"]):
        for name in llama.QUANTIZABLE_PROJS:
            q, r = layer[name], ref[name]
            assert q.mode == "int4" and q.bias is None
            for f in ("w4", "w4_gscale", "scales"):
                np.testing.assert_array_equal(getattr(q, f).numpy(), r[f])


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_engine_int4_generate_matches_jax_greedy(kv_quantized):
    jcfg, jparams = _params()
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=kv_quantized)
    jengine = JEngine(jparams, jcfg, JServe(**kw))
    want, want_lp = run_engine(jengine, JSampling)

    engine = Engine(_port(jparams), llama.ModelConfig.tiny(**CFG), ServeConfig(**kw), device="cpu")
    fused = engine.params["layers"]["qkv_proj"]
    assert fused.mode == "int4" and fused.w4.shape[0] == CFG["num_layers"]
    assert fused.w4_gscale.shape == (CFG["num_layers"], 2, 3 * CFG["hidden_size"])
    assert engine.params["layers"]["gateup_proj"].mode == "int4"
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)
    assert engine.prefix_stats == jengine.prefix_stats == {"hits": 1, "tokens_reused": 20}
