"""The port's 1x16 codes path (``ops/gather16``, B1) against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (``gather16`` is XLA
there, not Pallas; the flash-decode kernel runs in interpret mode) and the
port's counterparts (their plain versions: the tensors lie on the CPU).
Codes are drawn over 0..65535, so codes of 32768 and more, negative as the
port's int16, appear in every weight. Tolerances: bf16 outputs one bf16 step
(rtol 8e-3, atol 2e-3 of the largest value: both round an f32 sum taken in
another order), with a bias two (it is added after, in bf16: a second
rounding); f32 outputs rtol 1e-5, atol 1e-5 of the largest value (only the
f32 sum's order differs); the dequantized weight, codes and packed codebooks identical;
model logits rtol = atol = 2e-3 (f32 params); greedy Engine tokens
identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, f32, run_engine, t, to_numpy_tree

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.io.checkpoint import save_quantized_model
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import stacked as jstacked
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.ops import dequant as jdq
from aqlm_tpu.ops import gather16 as jg
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.ops.runtime import quantized_matmul as j_quantized_matmul
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu.serve.fuse import fuse_projections_codes as j_fuse
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.ops import dequant as dq
from aqlm_tpu_torch.ops import gather16 as g16
from aqlm_tpu_torch.ops.runtime import (
    IndexedQuantizedLinear,
    QuantizedLinear,
    quantized_matmul,
    quantized_matmul_indexed,
)
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig
from aqlm_tpu_torch.serve.fuse import fuse_projections_codes

OUT, IN = 96, 256
CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=4)


def _step_close(got, want, steps=1):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=steps * 8e-3, atol=2e-3 * np.abs(w).max())


@functools.cache
def _op_inputs(group):
    rng = np.random.default_rng(group)
    codes = rng.integers(0, 65536, (OUT, IN // group)).astype(np.uint16)
    assert codes.max() >= 32768
    packed = jg.pack_codebook_rows(jnp.asarray(rng.standard_normal((65536, group)), jnp.float32), group)
    scales = rng.uniform(0.5, 1.5, OUT).astype(np.float32)
    bias = (rng.standard_normal(OUT) * 0.1).astype(np.float32)
    return codes, packed, scales, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8, 33])
@pytest.mark.parametrize("group", [8, 16])
def test_gather_matmul_16_matches_jax(group, rows, with_bias):
    codes, packed, scales, bias = _op_inputs(group)
    tcodes = g16.codes16(torch.from_numpy(codes))
    assert tcodes.dtype == torch.int16 and bool((tcodes < 0).any())
    x = np.random.default_rng(rows).standard_normal((rows, IN)).astype(np.float32)
    for dt in (jnp.bfloat16, jnp.float32):
        jx = jnp.asarray(x, dt)
        jb = jnp.asarray(bias, dt) if with_bias else None
        want = jg.gather_matmul_16(jx, jnp.asarray(codes), packed, jnp.asarray(scales), jb,
                                   group=group)
        got = g16.gather_matmul_16(t(jx), tcodes, t(packed), t(scales),
                                   None if jb is None else t(jb), group=group)
        assert got.dtype == t(jx).dtype and got.shape == (rows, OUT)
        if dt == jnp.bfloat16:
            _step_close(got, want, 2 if with_bias else 1)
        else:
            np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                       atol=1e-5 * np.abs(f32(want)).max())


@pytest.mark.parametrize("group", [8, 16])
def test_dequantize_gather16_matches_jax_exactly(group):
    codes, packed, scales, _ = _op_inputs(group)
    want = jg.dequantize_gather16(jnp.asarray(codes), packed, jnp.asarray(scales), group=group)
    got = g16.dequantize_gather16(g16.codes16(torch.from_numpy(codes)), t(packed), t(scales),
                                  group=group)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(), np.asarray(want).view(np.uint16))


def test_codes16_keeps_the_bits():
    vals = np.array([0, 1, 32767, 32768, 40000, 65535])
    got = g16.codes16(torch.from_numpy(vals.astype(np.uint16)))
    assert got.dtype == torch.int16 and g16.codes16(got) is got
    np.testing.assert_array_equal((got.to(torch.int32) & 0xFFFF).numpy(), vals)
    with pytest.raises(ValueError, match="uint16 or int16"):
        g16.codes16(torch.from_numpy(vals.astype(np.int32)))


@pytest.mark.parametrize("scheme_name", ["1x16g8", "1x16g16"])
def test_from_aqlm_1x16_matches_jax(scheme_name):
    """Codes keep their values (the port's int16 read unsigned), the packed
    codebook is byte-identical, and quantized_matmul (stacked too) agrees."""
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(3), JScheme.parse(scheme_name), 128, 256,
                               with_bias=True)
    jq = JQuantizedLinear.from_aqlm(w, mode="codes")
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales),
                       bias=t(w.bias), scheme=AqlmScheme.parse(scheme_name))
    q = QuantizedLinear.from_aqlm(pw, mode="codes")
    assert q.codes.dtype == torch.int16 and q.codes_tl is None and q.codebooks is None
    np.testing.assert_array_equal((q.codes.to(torch.int32) & 0xFFFF).numpy(),
                                  np.asarray(jq.codes).astype(np.int32))
    np.testing.assert_array_equal(q.packed_cb.view(torch.uint16).numpy(),
                                  np.asarray(jq.packed_cb).view(np.uint16))
    x = np.random.default_rng(0).standard_normal((2, 3, 256)).astype(np.float32)
    want = np.asarray(j_quantized_matmul(jnp.asarray(x), jq))
    np.testing.assert_allclose(quantized_matmul(torch.from_numpy(x), q).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    stacked = stack_layer_params({"layers": [{"p": q}, {"p": q}]})["layers"]["p"]
    assert stacked.packed_cb.shape[0] == 2
    np.testing.assert_allclose(
        quantized_matmul_indexed(torch.from_numpy(x), IndexedQuantizedLinear(stacked, 1)).numpy(),
        want, rtol=1e-5, atol=1e-5)


@functools.cache
def _params(dtype=jnp.float32):
    jcfg = jllama.ModelConfig.tiny(**CFG)
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, JScheme.parse("1x16g8"),
                                           mode="codes", dtype=dtype)


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def test_llama_forward_1x16_matches_jax():
    jcfg, jparams = _params()
    cfg = llama.ModelConfig.tiny(**CFG)
    params = _port(jparams)
    q = params["layers"][0]["q_proj"]
    assert q.packed_cb is not None and q.codes.dtype == torch.int16
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    want, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids))
    got, _ = llama.forward(params, cfg, torch.from_numpy(ids))
    assert got.shape == (2, 11, cfg.vocab_size)
    assert_close(got, want)


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_forward_stacked_1x16_matches_jax(kv_quantized):
    """1x16 layers stay unfused (fusion takes tiled Kx8 codes only) and
    turn on the flash rule (K3) as any codes layer does: prefill, then two
    decode steps."""
    jcfg, jparams = _params()
    cfg = llama.ModelConfig.tiny(**CFG)
    jst = jstacked.stack_layer_params(j_fuse(jparams, jcfg))
    st = stack_layer_params(fuse_projections_codes(_port(jparams), cfg))
    assert "qkv_proj" not in st["layers"] and "qkv_proj" not in jst["layers"]
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 14))
    jcache = jstacked.init_kv_cache(jcfg, 2, 128, quantized=kv_quantized)
    cache = init_kv_cache(cfg, 2, 128, quantized=kv_quantized, device="cpu")
    want, jcache = jstacked.forward_stacked(jst, jcfg, jnp.asarray(ids[:, :12]), cache=jcache,
                                            cache_offset=0)
    got, cache = forward_stacked(st, cfg, torch.from_numpy(ids[:, :12]), cache=cache,
                                 cache_offset=0)
    assert_close(got, want)
    for p in (12, 13):
        want, jcache = jstacked.forward_stacked(jst, jcfg, jnp.asarray(ids[:, p:p + 1]),
                                                cache=jcache, cache_offset=p)
        got, cache = forward_stacked(st, cfg, torch.from_numpy(ids[:, p:p + 1]), cache=cache,
                                     cache_offset=p)
        assert_close(got, want)


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_engine_1x16_generate_matches_jax_greedy(kv_quantized):
    jcfg, jparams = _params()
    cfg = llama.ModelConfig.tiny(**CFG)
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=kv_quantized)
    want, want_lp = run_engine(JEngine(jparams, jcfg, JServe(**kw)), JSampling)
    engine = Engine(_port(jparams), cfg, ServeConfig(**kw), device="cpu")
    assert engine.params["layers"]["q_proj"].packed_cb.shape[0] == cfg.num_layers
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_load_quantized_model_reads_jax_1x16_codes_checkpoint(tmp_path):
    """aqlm_tpu's 1x16 codes checkpoint (bf16: uint16 codes and the packed
    codebook) loads with the same arrays and serves the tokens of the same
    params carried across in memory."""
    jcfg, jparams = _params(jnp.bfloat16)
    save_quantized_model(str(tmp_path), jparams, jcfg)
    params, cfg = load_quantized_model(str(tmp_path), device="cpu")
    assert cfg == llama.ModelConfig.tiny(**CFG)
    want = to_numpy_tree(jparams)
    for layer, ref in zip(params["layers"], want["layers"]):
        for name in ("q_proj", "down_proj"):
            q, r = layer[name], ref[name]
            assert q.mode == "codes" and q.codes.dtype == torch.int16
            np.testing.assert_array_equal((q.codes.to(torch.int32) & 0xFFFF).numpy(),
                                          r["codes"].astype(np.int32))
            np.testing.assert_array_equal(q.packed_cb.view(torch.uint16).numpy(),
                                          r["packed_cb"]["__bf16__"])
            np.testing.assert_array_equal(q.scales.numpy(), r["scales"])
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=True)
    prompts, sampling = [np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3)
    got = Engine(params, cfg, ServeConfig(**kw), device="cpu").generate(prompts, sampling)
    assert got == Engine(_port(jparams), cfg, ServeConfig(**kw), device="cpu").generate(prompts,
                                                                                     sampling)
    assert [len(o) for o in got] == [3, 3]


def test_port_random_1x16_params_serve():
    """The port's own random 1x16 model builds without JAX and serves."""
    cfg = llama.ModelConfig.tiny(**{**CFG, "num_layers": 1})
    params = random_quantized_params(torch.Generator().manual_seed(0), cfg,
                                     AqlmScheme.parse("1x16g8"), mode="codes", device="cpu")
    assert params["layers"][0]["gate_proj"].packed_cb.shape == (65536 * 8 // 128, 128)
    out = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32)),
                 device="cpu").generate([np.arange(5), np.arange(20)], SamplingParams(max_new_tokens=3))
    assert [len(o) for o in out] == [3, 3]
