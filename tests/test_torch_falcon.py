"""The port's Falcon codes serving against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as the JAX tests run them) and the port's counterparts
(their plain versions: the tensors lie on the CPU). Tolerances:
``fused_onehot_matmul`` with bf16 activations one bf16 step
(2^-7 |ref| + 1e-3 max|ref|: both round an f32 sum taken in another order),
with f32 activations rtol = atol = 1e-5 (only the f32 sum's order differs);
attention one bf16 step (rtol 8e-3, atol 2e-3) with the caches written
identically; model logits rtol = atol = 2e-3 (f32 params); codes and
checkpoint arrays identical; greedy Engine tokens identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, run_engine, t, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.io.checkpoint import save_quantized_model
from aqlm_tpu.models import falcon as jfalcon
from aqlm_tpu.models import stacked as jstacked
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize_projections
from aqlm_tpu.ops import dequant as jdq
from aqlm_tpu.ops import flash_decode as jfd
from aqlm_tpu.ops import kernels as jk
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.config import SCHEME_2X8 as T_SCHEME_2X8
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import falcon, family
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.ops import dequant as dq
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import kernels as k
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

G = 8
# q/k/v/o/fc2 keep the untiled codes (OUT 96 and 16), fc1 the tiled (OUT 384)
CFG = dict(num_layers=2, hidden_size=96, intermediate_size=384, num_heads=6, num_kv_heads=1)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return jfalcon.FalconConfig.tiny(**kw), falcon.FalconConfig.tiny(**kw)


@functools.cache
def _params(mode="codes", dtype=jnp.float32):
    """JAX Falcon params: dense, or every projection random 2x8 codes in ``mode``."""
    jcfg, _ = _cfgs()
    params = jfalcon.init_random_params(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    if mode != "dense":
        params = j_random_quantize_projections(jax.random.PRNGKey(1), params, SCHEME_2X8, mode=mode)
    return jcfg, params


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _onehot_inputs(rng, out_f, in_f=128, L=2):
    codes = rng.integers(0, 256, (L, 2, in_f // G, out_f), dtype=np.uint8)
    jcb = jnp.asarray(rng.standard_normal((L, 2, 256, G)) / 4, jnp.bfloat16)
    scales = rng.uniform(0.5, 1.5, (L, out_f)).astype(np.float32)
    bias = rng.standard_normal((L, out_f)).astype(np.float32)
    return codes, jcb, t(jcb), scales, bias


@pytest.mark.parametrize("variant", ["bias", "indexed"])
@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 3, 8, 33])
@pytest.mark.parametrize("out_f", [64, 96, 200])
def test_fused_onehot_matmul_matches_jax(out_f, rows, x_dtype, variant):
    """"bias": one layer's arrays with a bias; "indexed": layer 1 of stacked
    arrays read in place, against the JAX kernel on that layer's arrays."""
    rng = np.random.default_rng(out_f + rows)
    codes, jcb, tcb, scales, bias = _onehot_inputs(rng, out_f)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    tx = t(jx)
    if variant == "bias":
        want = jk.fused_onehot_matmul(jx, jnp.asarray(codes[0]), jcb[0], jnp.asarray(scales[0]),
                                      jnp.asarray(bias[0]), group=G)
        got = k.fused_onehot_matmul(tx, t(codes[0]), tcb[0], t(scales[0]), t(bias[0]), group=G)
    else:
        want = jk.fused_onehot_matmul(jx, jnp.asarray(codes[1]), jcb[1], jnp.asarray(scales[1]),
                                      group=G)
        got = k.fused_onehot_matmul_indexed(tx, t(codes), tcb, t(scales), 1, group=G)
    assert got.dtype == tx.dtype and got.shape == (rows, out_f)
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if x_dtype == "bf16":
        assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-3 * np.abs(w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_f", [64, 200, 4544])
def test_from_aqlm_codes_untiled_matches_jax_exactly(out_f):
    """OUT not a multiple of 128 keeps the untiled [K, IG, OUT] codes, byte
    for byte those of aqlm_tpu, and serves them through B15."""
    w = jdq.random_aqlm_weight(jax.random.PRNGKey(out_f), SCHEME_2X8, out_f, 64)
    pw = dq.AqlmWeight(codes=t(w.codes), codebooks=t(w.codebooks), scales=t(w.scales), bias=None,
                       scheme=T_SCHEME_2X8)
    jq, q = JQuantizedLinear.from_aqlm(w, mode="codes"), QuantizedLinear.from_aqlm(pw, mode="codes")
    assert jq.codes_tl is None and q.codes_tl is None and q.codes_t.is_contiguous()
    np.testing.assert_array_equal(q.codes_t.numpy(), np.asarray(jq.codes_t))
    np.testing.assert_array_equal(q.codebooks.view(torch.uint16).numpy(),
                                  np.asarray(jq.codebooks).view(np.uint16))
    np.testing.assert_array_equal(q.scales.numpy(), np.asarray(jq.scales))
    x = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32)
    want = jk.fused_onehot_matmul(jnp.asarray(x), jq.codes_t, jq.codebooks, jq.scales, group=G)
    np.testing.assert_allclose(k.fused_onehot_matmul(torch.from_numpy(x), q.codes_t, q.codebooks,
                                                     q.scales, group=G).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rep", [6, 71])
def test_flash_decode_write_attention_any_rep_matches_jax(rep, quantized, window):
    """K3's plain version at 6 and 71 query heads per kv head (Falcon-7B's
    71 over one kv head, D=64)."""
    rng = np.random.default_rng(rep)
    L, B, HKV, S, D = 2, 3, 1, 128, 64
    offsets = np.array([0, 32, 127], np.int32)
    q = rng.standard_normal((B, 1, HKV * rep, D)).astype(np.float32)
    if quantized:
        cache = [rng.integers(-127, 128, (L, B, HKV, S, D), dtype=np.int8) for _ in range(2)]
        scales = [rng.uniform(0.001, 0.02, (L, B, HKV, S, 1)).astype(np.float32) for _ in range(2)]
        new = [rng.integers(-127, 128, (B, 1, HKV, D), dtype=np.int8) for _ in range(2)]
        new_s = [rng.uniform(0.001, 0.02, (B, 1, HKV, 1)).astype(np.float32) for _ in range(2)]
        jc, tc = [jnp.asarray(c) for c in cache], [torch.from_numpy(c.copy()) for c in cache]
        js, ts = [jnp.asarray(s) for s in scales], [torch.from_numpy(s.copy()) for s in scales]
        jns, tns = [jnp.asarray(s) for s in new_s], [torch.from_numpy(s) for s in new_s]
    else:
        cache = [jnp.asarray(rng.standard_normal((L, B, HKV, S, D)), jnp.bfloat16) for _ in range(2)]
        new = [rng.standard_normal((B, 1, HKV, D)).astype(np.float32) for _ in range(2)]
        jc, tc = cache, [t(c).clone() for c in cache]
        js = ts = jns = tns = [None, None]
    jn, tn_ = [jnp.asarray(n) for n in new], [torch.from_numpy(n) for n in new]
    want = jfd.flash_decode_write_attention_indexed(
        jnp.asarray(q), jn[0], jn[1], jc[0], jc[1], js[0], js[1], 1, jnp.asarray(offsets),
        k_scale_new=jns[0], v_scale_new=jns[1], window=window)
    got = fd.flash_decode_write_attention_indexed(
        torch.from_numpy(q), tn_[0], tn_[1], tc[0], tc[1], ts[0], ts[1], 1,
        torch.from_numpy(offsets), k_scale_new=tns[0], v_scale_new=tns[1], window=window)
    assert got[0].shape == (B, 1, HKV * rep, D) and got[1] is tc[0]  # written in place
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               rtol=8e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):
        if w is not None:
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_falcon_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 96)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(96).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    assert_close(falcon.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
                 jfalcon.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5))
    # jax.nn.gelu's default is the tanh approximation
    np.testing.assert_allclose(falcon.gelu(torch.from_numpy(x), torch.float32).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "codes"])
def test_falcon_forward_matches_jax(mode):
    jcfg, jparams = _params(mode)
    _, cfg = _cfgs()
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    want, _ = jfalcon.forward(jparams, jcfg, jnp.asarray(ids))
    got, caches = falcon.forward(_port(jparams), cfg, torch.from_numpy(ids))
    assert caches is None
    assert got.shape == (2, 9, cfg.vocab_size)
    assert_close(got, want)


@pytest.mark.parametrize("kv_quantized", [True, False])
@pytest.mark.parametrize("mode", ["dense", "codes"])
def test_forward_stacked_falcon_matches_jax(mode, kv_quantized):
    """Prefill then one decode step per row at max_len 128: codes layers take
    K3 (71-way-style GQA: 6 query heads over one kv head), dense layers the
    plain attention over the cache."""
    jcfg, jparams = _params(mode)
    _, cfg = _cfgs()
    jst = jstacked.stack_layer_params(jparams)
    st = stack_layer_params(_port(jparams))
    if mode == "codes":
        assert st["layers"]["q_proj"].codes_t.shape == (2, 2, 12, 96)  # [L, K, IG, OUT]
        assert st["layers"]["fc1"].codes_tl is not None
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    jcache = jstacked.init_kv_cache(jcfg, 2, 128, quantized=kv_quantized)
    cache = init_kv_cache(cfg, 2, 128, quantized=kv_quantized, device="cpu")
    want, jcache = jstacked.forward_stacked(jst, jcfg, jnp.asarray(ids[:, :11]), cache=jcache,
                                            cache_offset=0)
    got, cache = forward_stacked(st, cfg, torch.from_numpy(ids[:, :11]), cache=cache,
                                 cache_offset=0)
    assert_close(got, want)
    offsets = np.array([11, 11], np.int32)
    want, _ = jstacked.forward_stacked(jst, jcfg, jnp.asarray(ids[:, 11:]), cache=jcache,
                                       cache_offset=jnp.asarray(offsets))
    got, _ = forward_stacked(st, cfg, torch.from_numpy(ids[:, 11:]), cache=cache,
                             cache_offset=torch.from_numpy(offsets))
    assert_close(got, want)


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_engine_falcon_generate_matches_jax_greedy(kv_quantized):
    """Codes mode: q/k/v stay unfused (untiled codes), as in aqlm_tpu."""
    jcfg, jparams = _params("codes")
    _, cfg = _cfgs()
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=kv_quantized)
    want, want_lp = run_engine(JEngine(jparams, jcfg, JServe(**kw)), JSampling)
    engine = Engine(_port(jparams), cfg, ServeConfig(**kw), device="cpu")
    layers = engine.params["layers"]
    assert "qkv_proj" not in layers and layers["o_proj"].codes_t is not None
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_load_quantized_model_reads_jax_falcon_codes_checkpoint(tmp_path):
    """aqlm_tpu's Falcon codes checkpoint (bf16) loads with the same config
    and arrays, and serves the tokens of the same params carried in memory."""
    jcfg, jparams = _params("codes", jnp.bfloat16)
    save_quantized_model(str(tmp_path), jparams, jcfg)
    params, cfg = load_quantized_model(str(tmp_path), device="cpu")
    assert cfg == _cfgs()[1] and isinstance(cfg, falcon.FalconConfig)
    want = to_numpy_tree(jparams)
    np.testing.assert_array_equal(params["final_norm_bias"].view(torch.uint16).numpy(),
                                  want["final_norm_bias"]["__bf16__"])
    for layer, ref in zip(params["layers"], want["layers"]):
        np.testing.assert_array_equal(layer["input_norm_bias"].view(torch.uint16).numpy(),
                                      ref["input_norm_bias"]["__bf16__"])
        for name, field in (("q_proj", "codes_t"), ("k_proj", "codes_t"), ("fc1", "codes_tl"),
                            ("fc2", "codes_t")):
            np.testing.assert_array_equal(getattr(layer[name], field).numpy(), ref[name][field])
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=True)
    prompts, sampling = [np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3)
    got = Engine(params, cfg, ServeConfig(**kw), device="cpu").generate(prompts, sampling)
    assert got == Engine(_port(jparams), cfg, ServeConfig(**kw), device="cpu").generate(prompts, sampling)
    assert [len(o) for o in got] == [3, 3]


def test_port_random_falcon_params_serve():
    """The port's own random_quantized_params build a Falcon (untiled codes
    for q/k/v/o/fc2, tiled for fc1) and serve it end to end."""
    _, cfg = _cfgs()
    params = random_quantized_params(torch.Generator().manual_seed(0), cfg, T_SCHEME_2X8,
                                     device="cpu")
    assert family.family_name(cfg) == "falcon"
    layer = params["layers"][0]
    assert {n for n in falcon.projection_shapes(cfg) if layer[n].codes_t is not None} == {
        "q_proj", "k_proj", "v_proj", "o_proj", "fc2"}
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True), device="cpu")
    out = engine.generate([np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3))
    assert [len(o) for o in out] == [3, 3]
    with pytest.raises(NotImplementedError, match="A12"):
        falcon.block_forward_with_taps(None, layer, cfg, None)
