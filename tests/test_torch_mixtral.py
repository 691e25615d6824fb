"""The port's Mixtral (sparse-MoE) serving against aqlm_tpu on the CPU.

The same numpy inputs go through the JAX functions (the Pallas int8, int4
and codes kernels in interpret mode, as the JAX tests run them) and the
port's counterparts (their plain versions: the tensors lie on the CPU).
Tolerances: bf16 outputs one bf16 step (rtol 8e-3, atol 2e-3), f32 outputs
rtol = atol = 2e-3, routing weights rtol = atol = 1e-6 with the same experts
selected; stacked int8 and int4 experts and checkpoint arrays identical;
greedy Engine tokens identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, f32, run_engine, t, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.io.checkpoint import save_quantized_model
from aqlm_tpu.models import mixtral as jmixtral
from aqlm_tpu.models import stacked as jstacked
from aqlm_tpu.models.common import DenseLinear as JDense
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize_projections
from aqlm_tpu.ops import int4_matmul as j4
from aqlm_tpu.ops import int8_matmul as jim
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.config import SCHEME_1X16 as T_SCHEME_1X16
from aqlm_tpu_torch.config import SCHEME_2X8 as T_SCHEME_2X8
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import family, llama, mixtral
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.quantize import random_quantize_projections, random_quantized_params
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

# every projection's OUT a multiple of 128 (codes mode), GQA kept
CFG = dict(num_layers=2, hidden_size=256, intermediate_size=256, num_heads=4, num_kv_heads=2)
E, OUT = 3, 256


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return jmixtral.MixtralConfig.tiny_moe(**kw), mixtral.MixtralConfig.tiny_moe(**kw)


@functools.cache
def _params(mode="int8", dtype=jnp.float32, num_layers=2):
    """JAX Mixtral params: dense, or every projection but the router random
    2x8 codes in ``mode``."""
    jcfg, _ = _cfgs(num_layers=num_layers)
    params = jmixtral.init_random_params(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    if mode != "dense":
        params = j_random_quantize_projections(jax.random.PRNGKey(1), params, SCHEME_2X8, mode=mode)
    return jcfg, params


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _moe_inputs(rng, in_f, L=2):
    w8 = rng.integers(-127, 128, (L, E, OUT, im.pad_in_features(in_f)), dtype=np.int8)
    w8[..., in_f:] = 0
    scale = (rng.uniform(0.5, 1.5, (L, E, OUT)) / (127 * in_f ** 0.5)).astype(np.float32)
    return w8, scale


@pytest.mark.parametrize("in_f", [256, 1040])  # 1040 pads to 2048
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 5, 8, 16])
def test_int8_moe_matmul_matches_jax(rows, per_expert, in_f):
    rng = np.random.default_rng(rows + 10 * per_expert + in_f)
    w8, scale = _moe_inputs(rng, in_f)
    x = rng.standard_normal((E, rows, in_f) if per_expert else (rows, in_f)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = t(jx)
    want = jim.int8_moe_matmul_indexed(jx, jnp.asarray(w8), jnp.asarray(scale), 1)
    got = im.int8_moe_matmul_indexed(tx, t(w8), t(scale), 1)
    assert got.shape == (E, rows, OUT) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=8e-3, atol=2e-3)
    if rows in (1, 16):  # the unstacked form (one kernel, no layer offset) on both paths
        want0 = jim.int8_moe_matmul(jx, jnp.asarray(w8[0]), jnp.asarray(scale[0]))
        np.testing.assert_allclose(f32(im.int8_moe_matmul(tx, t(w8[0]), t(scale[0]))),
                                   f32(want0), rtol=8e-3, atol=2e-3)


@functools.cache
def _moe_int4_inputs(in_f, L=2):
    """Stacked all-expert int4 weights [L, E, OUT, IN_pad/2] and group
    scales [L, E, IN_pad/128, OUT], quantized by aqlm_tpu from random dense
    ones."""
    rng = np.random.default_rng(in_f)
    packs = [j4.quantize_int4(jnp.asarray(rng.standard_normal((OUT, in_f)), jnp.float32) * in_f ** -0.5)
             for _ in range(L * E)]
    w4 = np.stack([np.asarray(p[0]) for p in packs]).reshape(L, E, OUT, -1)
    gs = np.stack([np.asarray(p[1]) for p in packs]).reshape(L, E, -1, OUT)
    return w4, gs


@pytest.mark.parametrize("in_f", [96, 1040])  # pad to 256 and 2048
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 5, 8, 16])
def test_int4_moe_matmul_matches_jax(rows, per_expert, in_f):
    w4, gs = _moe_int4_inputs(in_f)
    assert w4.shape[-1] == i4.pad_in_features_int4(in_f) // 2
    rng = np.random.default_rng(rows + 10 * per_expert + in_f)
    x = rng.standard_normal((E, rows, in_f) if per_expert else (rows, in_f)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = t(jx)
    want = j4.int4_moe_matmul_indexed(jx, jnp.asarray(w4), jnp.asarray(gs), 1)
    got = i4.int4_moe_matmul_indexed(tx, t(w4), t(gs), 1)
    assert got.shape == (E, rows, OUT) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=8e-3, atol=2e-3)
    if rows in (1, 16):  # the unstacked form (one kernel, no layer offset) on both paths
        want0 = j4.int4_moe_matmul(jx, jnp.asarray(w4[0]), jnp.asarray(gs[0]))
        np.testing.assert_allclose(f32(i4.int4_moe_matmul(tx, t(w4[0]), t(gs[0]))),
                                   f32(want0), rtol=8e-3, atol=2e-3)


def test_int4_moe_matmul_nibble_order_one_hot():
    """Per-expert one-hot x: expert e's row r picks column cols[e][r] of its
    own dequantized weight, exactly (both nibbles, several packing blocks)."""
    w4, gs = _moe_int4_inputs(1040)
    cols = [[0, 127, 128, 300], [255, 256, 383, 1039], [5, 511, 512, 900]]
    x = np.zeros((E, 4, 1040), np.float32)
    for e, cs in enumerate(cols):
        x[e, np.arange(4), cs] = 1.0
    got = i4.int4_moe_matmul(torch.from_numpy(x), t(w4[0]), t(gs[0]))
    for e, cs in enumerate(cols):
        oracle = np.asarray(j4.dequantize_int4(jnp.asarray(w4[0, e]), jnp.asarray(gs[0, e])))
        np.testing.assert_array_equal(got[e].numpy(), oracle[:, cs].T)


def test_stack_experts_int4_matches_jax_exactly():
    jcfg, jparams = _params("int4")
    _, cfg = _cfgs()
    want = jmixtral.stack_experts(jparams["layers"][0], jcfg)
    layer = _port(jparams)["layers"][0]
    got = mixtral.stack_experts(layer, cfg)
    assert set(got) == set(want) and not any(k.startswith("experts.") for k in got)
    for proj in mixtral.EXPERT_PROJS:
        g, w = got[f"experts_{proj}"], want[f"experts_{proj}"]
        assert isinstance(g, mixtral.StackedInt4Experts) and g.w4.shape[0] == cfg.num_experts
        np.testing.assert_array_equal(g.w4.numpy(), np.asarray(w.w4))
        np.testing.assert_array_equal(g.gscale.numpy(), np.asarray(w.gscale))
        # JAX's stacked form carries across through the numpy tree as it is
        c = params_from_numpy(to_numpy_tree(w), device="cpu")
        assert isinstance(c, mixtral.StackedInt4Experts)
        assert torch.equal(c.w4, g.w4) and torch.equal(c.gscale, g.gscale)
    donated = mixtral.stack_experts(layer, cfg, donate=True)
    assert donated is layer and set(donated) == set(want)
    np.testing.assert_array_equal(donated["experts_down_proj"].w4.numpy(),
                                  np.asarray(want["experts_down_proj"].w4))


def test_stack_experts_int8_matches_jax_exactly():
    jcfg, jparams = _params()
    _, cfg = _cfgs()
    want = jmixtral.stack_experts(jparams["layers"][0], jcfg)
    layer = _port(jparams)["layers"][0]
    got = mixtral.stack_experts(layer, cfg)
    assert set(got) == set(want) and not any(k.startswith("experts.") for k in got)
    for proj in mixtral.EXPERT_PROJS:
        g, w = got[f"experts_{proj}"], want[f"experts_{proj}"]
        assert isinstance(g, mixtral.StackedInt8Experts) and g.w8.shape[0] == cfg.num_experts
        np.testing.assert_array_equal(g.w8.numpy(), np.asarray(w.w8))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    # donate: the same dict, its per-expert entries gone
    donated = mixtral.stack_experts(layer, cfg, donate=True)
    assert donated is layer and set(donated) == set(want)
    np.testing.assert_array_equal(donated["experts_down_proj"].w8.numpy(),
                                  np.asarray(want["experts_down_proj"].w8))


@pytest.mark.parametrize("tie", [False, True])
def test_routing_matches_jax(tie):
    """Top-2 of 4 experts; with ``tie`` the router's rows 1 and 2 are equal
    and rank second, so an exact tie keeps three experts, as in JAX."""
    jcfg, cfg = _cfgs(hidden_size=64)
    rng = np.random.default_rng(3)
    gate = rng.standard_normal((cfg.num_experts, 64)).astype(np.float32) / 8
    if tie:
        gate[2] = gate[1]
        gate[0] = 3 * gate[1]
        gate[3] = -gate[1]
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jmixtral._routing(jnp.asarray(x), {"moe_gate": JDense(jnp.asarray(gate), None)},
                                        jcfg))
    got = mixtral._routing(torch.from_numpy(x), {"moe_gate": DenseLinear(t(gate), None)}, cfg).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) == (3 if tie else 2)).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _stacked_pair(mode, dtype):
    """(JAX, port) serving-form params: experts stacked, then the layers."""
    jcfg, jparams = _params(mode, dtype)
    _, cfg = _cfgs()
    jst = jstacked.stack_layer_params(
        {**jparams, "layers": [jmixtral.stack_experts(l, jcfg) for l in jparams["layers"]]})
    params = _port(jparams)
    st = stack_layer_params(
        {**params, "layers": [mixtral.stack_experts(l, cfg) for l in params["layers"]]})
    return jcfg, jst, cfg, st


@pytest.mark.parametrize("mode,dtype", [("int8", "f32"), ("int8", "bf16"), ("dense", "f32"),
                                        ("int4", "f32"), ("int4", "bf16")])
def test_moe_mlp_stacked_indexed_matches_jax(mode, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcfg, jst, cfg, st = _stacked_pair(mode, jdt)
    x = np.random.default_rng(4).standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    idx = 1
    jlayer = {"moe_gate": JDense(jst["layers"]["moe_gate"].weight[idx], None)}
    layer = {"moe_gate": DenseLinear(st["layers"]["moe_gate"].weight[idx], None)}
    want = jmixtral.moe_mlp_stacked_indexed(jx, jlayer, jst["layers"], idx, jcfg)
    got = mixtral.moe_mlp_stacked_indexed(t(jx), layer, st["layers"], idx, cfg)
    assert got.dtype == t(jx).dtype
    if dtype == "bf16":
        np.testing.assert_allclose(f32(got), f32(want), rtol=8e-3, atol=2e-3)
    else:
        assert_close(got, want)
    # the unstacked-layer form: the same layer's experts stacked alone
    jl = jmixtral.stack_experts(_params(mode, jdt)[1]["layers"][idx], jcfg)
    pl = mixtral.stack_experts(_port(_params(mode, jdt)[1])["layers"][idx], cfg)
    want1 = jmixtral.moe_mlp_stacked(jx, jl, jcfg)
    got1 = mixtral.moe_mlp_stacked(t(jx), pl, cfg)
    if dtype == "bf16":
        np.testing.assert_allclose(f32(got1), f32(want1), rtol=8e-3, atol=2e-3)
    else:
        assert_close(got1, want1)


@pytest.mark.parametrize("mode", ["reference", "int8", "int4"])
def test_mixtral_forward_matches_jax(mode):
    jcfg, jparams = _params(mode)
    _, cfg = _cfgs()
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    want, _ = jmixtral.forward(jparams, jcfg, jnp.asarray(ids))
    got, caches = mixtral.forward(_port(jparams), cfg, torch.from_numpy(ids))
    assert caches is None
    assert got.shape == (2, 9, cfg.vocab_size)
    assert_close(got, want)


def _forward_stacked_check(mode, kv_quantized):
    """Prefill then one decode step per row; max_len 1024 takes the flash
    rule for int8 and int4 layers (K3, GQA with 2 query heads per kv head)."""
    jcfg, jst, cfg, st = _stacked_pair(mode, jnp.float32)
    stacked = st["layers"]["experts_up_proj"]
    assert type(stacked).__name__ == type(jst["layers"]["experts_up_proj"]).__name__
    assert type(stacked) is {"int8": mixtral.StackedInt8Experts, "int4": mixtral.StackedInt4Experts}[mode]
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    jcache = jstacked.init_kv_cache(jcfg, 2, 1024, quantized=kv_quantized)
    cache = init_kv_cache(cfg, 2, 1024, quantized=kv_quantized, device="cpu")
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
def test_forward_stacked_mixtral_matches_jax(kv_quantized):
    _forward_stacked_check("int8", kv_quantized)


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_forward_stacked_mixtral_int4_matches_jax(kv_quantized):
    _forward_stacked_check("int4", kv_quantized)


def _load_checkpoint_check(mode, path):
    """Save aqlm_tpu's Mixtral in ``mode`` (bf16), load it with the port:
    the same config and the same arrays. Returns (JAX params, port params, cfg)."""
    jcfg, jparams = _params(mode, jnp.bfloat16)
    save_quantized_model(str(path), jparams, jcfg)
    params, cfg = load_quantized_model(str(path), device="cpu")
    assert cfg == _cfgs()[1] and isinstance(cfg, mixtral.MixtralConfig)
    want = to_numpy_tree(jparams)
    fields = {"int8": ("w8", "w8_scale", "scales"), "int4": ("w4", "w4_gscale", "scales")}[mode]
    for layer, ref in zip(params["layers"], want["layers"]):
        np.testing.assert_array_equal(layer["moe_gate"].weight.view(torch.uint16).numpy(),
                                      ref["moe_gate"]["weight"]["__bf16__"])
        for name in mixtral.quantizable_proj_names(cfg):
            q, r = layer[name], ref[name]
            assert q.mode == mode and q.bias is None
            for f in fields:
                np.testing.assert_array_equal(getattr(q, f).numpy(), r[f])
    return jparams, params, cfg


def test_load_quantized_model_reads_jax_mixtral_int8_checkpoint(tmp_path):
    _load_checkpoint_check("int8", tmp_path)


def test_load_quantized_model_reads_jax_mixtral_int4_checkpoint(tmp_path):
    """The int4 checkpoint loads and serves: the loaded model's greedy tokens
    are those of the same params carried across in memory."""
    jparams, params, cfg = _load_checkpoint_check("int4", tmp_path)
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=True)
    prompts, sampling = [np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3)
    loaded = Engine(params, cfg, ServeConfig(**kw, donate_params=True), device="cpu")
    assert isinstance(loaded.params["layers"]["experts_gate_proj"], mixtral.StackedInt4Experts)
    got = loaded.generate(prompts, sampling)
    assert got == Engine(_port(jparams), cfg, ServeConfig(**kw), device="cpu").generate(prompts, sampling)
    assert [len(o) for o in got] == [3, 3]


@pytest.mark.parametrize("mode", ["int8", "codes", "int4"])
def test_engine_mixtral_generate_matches_jax_greedy(mode):
    """int8: experts stacked for the all-expert kernel, int8 head, the
    port's load with donate_params; int4: the same with the int4 kernel and
    a dense head; codes: the per-expert loop over K1/K2."""
    jcfg, jparams = _params(mode, num_layers=1)
    _, cfg = _cfgs(num_layers=1)
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=True,
              lm_head_int8=mode == "int8")
    jengine = JEngine(jparams, jcfg, JServe(**kw))
    want, want_lp = run_engine(jengine, JSampling)

    engine = Engine(_port(jparams), cfg, ServeConfig(**kw, donate_params=True), device="cpu")
    layers = engine.params["layers"]
    if mode == "int8":
        assert isinstance(layers["experts_gate_proj"], mixtral.StackedInt8Experts)
        assert layers["experts_down_proj"].w8.shape[:2] == (1, cfg.num_experts)
        assert engine.params["lm_head"].mode == "int8"
    elif mode == "int4":
        assert isinstance(layers["experts_gate_proj"], mixtral.StackedInt4Experts)
        assert layers["experts_down_proj"].w4.shape[:2] == (1, cfg.num_experts)
        assert isinstance(engine.params["lm_head"], DenseLinear)
    else:
        assert layers["experts.0.gate_proj"].mode == "codes" and "qkv_proj" in layers
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def test_port_random_mixtral_params_serve():
    """The port's own random_quantized_params build a Mixtral without a dense
    copy (the router stays dense bf16) and serve it end to end."""
    _, cfg = _cfgs(num_layers=1)
    params = random_quantized_params(torch.Generator().manual_seed(0), cfg, T_SCHEME_2X8,
                                     mode="int8", device="cpu")
    layer = params["layers"][0]
    assert set(layer) == {"input_norm", "post_attn_norm", "moe_gate",
                          *mixtral.quantizable_proj_names(cfg)}
    assert isinstance(layer["moe_gate"], DenseLinear) and layer["moe_gate"].weight.dtype == torch.bfloat16
    assert all(layer[n].mode == "int8" for n in mixtral.quantizable_proj_names(cfg))
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             donate_params=True), device="cpu")
    assert all(v is None for v in layer.values())  # donated leaf by leaf
    out = engine.generate([np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3))
    assert [len(o) for o in out] == [3, 3]
    # the family-agnostic scaffold swaps the dense experts and skips the router
    dense = mixtral.init_random_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    random_quantize_projections(torch.Generator().manual_seed(2), dense, T_SCHEME_2X8, mode="int8")
    assert isinstance(dense["layers"][0]["moe_gate"], DenseLinear)
    assert dense["layers"][0]["experts.2.down_proj"].mode == "int8"


def test_unported_mixtral_paths_raise():
    _, cfg = _cfgs(num_layers=1)
    codes = random_quantized_params(torch.Generator().manual_seed(0), cfg, T_SCHEME_2X8,
                                    mode="codes", device="cpu")
    codes16 = random_quantized_params(torch.Generator().manual_seed(0), cfg,
                                      T_SCHEME_1X16, mode="codes", device="cpu")
    with pytest.raises(NotImplementedError, match="1x16"):  # stacked experts take Kx8 codes
        mixtral.stack_experts(codes16["layers"][0], cfg)
    with pytest.raises(NotImplementedError, match="A9"):
        family.config_class("opt")
    # the KV-cache path of the unstacked forward is ported (it raised A4 before)
    ids = torch.arange(3)[None, :]
    caches = llama.init_kv_cache(cfg, 1, 8, device="cpu")
    got, out_caches = mixtral.forward(codes, cfg, ids, kv_caches=caches, cache_offset=0)
    assert out_caches is caches and bool(caches[0][0][:, 3:].eq(0).all())
    assert torch.equal(got, mixtral.forward(codes, cfg, ids)[0])
