"""The port's int8 (W8A16) serving mode against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (the Pallas int8 kernels
in interpret mode, as the JAX tests run them) and the port's counterparts
(their plain versions: the tensors lie on the CPU). Tolerances: bf16 outputs
one bf16 step (rtol 8e-3, atol 2e-3), f32 outputs rtol = atol = 2e-3; the
int8 weights, their scales and checkpoint arrays are identical; greedy
Engine tokens are identical.
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
from aqlm_tpu.ops import int8_matmul as jim
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
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig
from aqlm_tpu_torch.serve import fuse

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=8)
OUT, IN = 256, 1152  # IN pads to 2048


def _int8_inputs(rng, L=1):
    w8 = rng.integers(-127, 128, (L, OUT, im.pad_in_features(IN)), dtype=np.int8)
    w8[..., IN:] = 0
    scale = (rng.uniform(0.5, 1.5, (L, OUT)) / (127 * IN ** 0.5)).astype(np.float32)
    bias = rng.standard_normal((L, OUT)).astype(np.float32)
    return w8, scale, bias


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


def test_pad_in_features_matches_jax():
    for n in (64, 1024, 1025, 1152, 4096, 11008, 14336):
        assert im.pad_in_features(n) == jim.pad_in_features(n)
    assert im.IN_PAD_MULTIPLE == jim.IN_PAD_MULTIPLE


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_int8_matmul_matches_jax(batch, with_bias, dtype):
    rng = np.random.default_rng(40 + batch)
    w8, scale, bias = _int8_inputs(rng)
    jx, tx = _x(rng, batch, dtype)
    jb, tb = (jnp.asarray(bias[0]), torch.from_numpy(bias[0])) if with_bias else (None, None)
    want = jim.int8_matmul(jx, jnp.asarray(w8[0]), jnp.asarray(scale[0]), jb)
    got = im.int8_matmul(tx, t(w8[0]), t(scale[0]), tb)
    assert got.shape == (batch, OUT)
    _check(got, want, dtype)


@pytest.mark.parametrize("batch", [3, 16])
def test_int8_matmul_indexed_matches_jax(batch):
    rng = np.random.default_rng(50 + batch)
    w8, scale, bias = _int8_inputs(rng, L=3)
    jx, tx = _x(rng, batch, "bf16")
    want = jim.int8_matmul_indexed(jx[None], jnp.asarray(w8), jnp.asarray(scale), 1,
                                   jnp.asarray(bias))
    got = im.int8_matmul_indexed(tx[None], t(w8), t(scale), 1, t(bias))
    assert got.shape == (1, batch, OUT)
    _check(got, want, "bf16")


@pytest.mark.parametrize("scheme_name,out_f,in_f", [("2x8g8", 256, 1152), ("1x16g8", 128, 256)])
def test_from_aqlm_int8_matches_jax_exactly(scheme_name, out_f, in_f):
    js = JScheme.parse(scheme_name)
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(7), js, out_f, in_f, with_bias=True)
    want = JQuantizedLinear.from_aqlm(w, mode="int8")
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales),
                       bias=t(w.bias), scheme=AqlmScheme.parse(scheme_name))
    got = QuantizedLinear.from_aqlm(pw, mode="int8")
    assert got.mode == "int8" and got.w8.shape == (out_f, im.pad_in_features(in_f))
    for f in ("w8", "w8_scale", "scales", "bias"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    x = np.random.default_rng(8).standard_normal((3, in_f)).astype(np.float32)
    assert_close(apply_linear(torch.from_numpy(x), got), j_apply_linear(jnp.asarray(x), want))


@functools.cache
def _params(dtype=jnp.float32, **cfg_kw):
    jcfg = jllama.ModelConfig.tiny(**{**CFG, **cfg_kw})
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode="int8",
                                           dtype=dtype)


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(f32(got), f32(want))


def test_fuse_projections_int8_matches_jax():
    jcfg, jparams = _params()
    # a bias on q only: the fused bias fills k and v with zeros
    layer0 = dict(jparams["layers"][0])
    q = layer0["q_proj"]
    layer0["q_proj"] = dataclasses.replace(
        q, bias=jnp.asarray(np.random.default_rng(3).standard_normal(q.w8.shape[0]), jnp.float32))
    jparams = {**jparams, "layers": [layer0] + jparams["layers"][1:]}
    want = jfuse.fuse_projections(jparams, jcfg)
    got = fuse.fuse_projections(_port(jparams), llama.ModelConfig.tiny(**CFG))
    x = np.random.default_rng(4).standard_normal((2, 3, CFG["hidden_size"])).astype(np.float32)
    for gl, wl in zip(got["layers"], want["layers"]):
        assert set(gl) == set(wl) and "qkv_proj" in gl and "gateup_proj" in gl
        for name in ("qkv_proj", "gateup_proj"):
            g, w = gl[name], wl[name]
            assert g.mode == "int8"
            for f in ("w8", "w8_scale", "scales", "bias"):
                if getattr(w, f) is None:
                    assert getattr(g, f) is None
                else:
                    _same(getattr(g, f), getattr(w, f))
        assert_close(apply_linear(torch.from_numpy(x), gl["qkv_proj"]),
                     j_apply_linear(jnp.asarray(x), wl["qkv_proj"]))
    with pytest.raises(NotImplementedError, match="A14"):
        fuse.fuse_projections(_port(jparams), llama.ModelConfig.tiny(**CFG), tp=2)


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_lm_head_int8_matches_jax(tied):
    jcfg, jparams = _params(tie_embeddings=tied)
    want = jfuse.quantize_lm_head_int8(jparams)["lm_head"]
    got = fuse.quantize_lm_head_int8(_port(jparams))["lm_head"]
    assert got.mode == "int8" and got.w8.shape == (jcfg.vocab_size, jcfg.hidden_size)
    for f in ("w8", "w8_scale", "scales"):
        _same(getattr(got, f), getattr(want, f))
    x = np.random.default_rng(6).standard_normal((1, 5, jcfg.hidden_size)).astype(np.float32)
    assert_close(apply_linear(torch.from_numpy(x), got),
                 j_apply_linear(jnp.asarray(x), want))


def test_load_quantized_model_reads_jax_int8_checkpoint(tmp_path):
    jcfg, jparams = _params(jnp.bfloat16)
    save_quantized_model(str(tmp_path), jparams, jcfg)
    params, cfg = load_quantized_model(str(tmp_path), device="cpu")
    assert cfg == llama.ModelConfig.tiny(**CFG)
    want = to_numpy_tree(jparams)
    for layer, ref in zip(params["layers"], want["layers"]):
        for name in llama.QUANTIZABLE_PROJS:
            q, r = layer[name], ref[name]
            assert q.mode == "int8" and q.bias is None
            for f in ("w8", "w8_scale", "scales"):
                np.testing.assert_array_equal(getattr(q, f).numpy(), r[f])


@pytest.mark.parametrize("kv_quantized,fuse_projections", [(True, True), (False, True),
                                                           (True, False)])
def test_engine_int8_generate_matches_jax_greedy(kv_quantized, fuse_projections):
    jcfg, jparams = _params()
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=kv_quantized,
              lm_head_int8=True, fuse_projections=fuse_projections)
    jengine = JEngine(jparams, jcfg, JServe(**kw))
    want, want_lp = run_engine(jengine, JSampling)

    engine = Engine(_port(jparams), llama.ModelConfig.tiny(**CFG), ServeConfig(**kw), device="cpu")
    fused = engine.params["layers"].get("qkv_proj")
    assert (fused is not None) == fuse_projections
    if fused is not None:
        assert fused.mode == "int8" and fused.w8.shape[0] == CFG["num_layers"]
    assert engine.params["lm_head"].mode == "int8"
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)
    assert engine.prefix_stats == jengine.prefix_stats == {"hits": 1, "tokens_reused": 20}
