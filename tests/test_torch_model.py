"""Parity of the port's Llama forward and stacked serving forward with
aqlm_tpu on the CPU, at small widths that are multiples of 128 so the tiled
codes, fused-projection and flash-decode paths engage (as tests/test_fuse.py).

Params are built by the JAX package (f32, 2x8 codes mode) and carried to
the port through numpy. Tolerance: rtol = atol = 2e-3 on f32 logits.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import stacked as jstacked
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve.fuse import fuse_projections_codes as j_fuse
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models import stacked
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.serve.fuse import fuse_projections_codes

CFGS = {
    "mha": dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=8),
    "gqa": dict(num_layers=2, hidden_size=256, intermediate_size=256, num_heads=4, num_kv_heads=2),
}


def _cfgs(name):
    return jllama.ModelConfig.tiny(**CFGS[name]), llama.ModelConfig.tiny(**CFGS[name])


@functools.cache
def _model(name):
    jcfg, cfg = _cfgs(name)
    jparams = j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode="codes",
                                        dtype=jnp.float32)
    tparams = params_from_numpy(to_numpy_tree(jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _ids(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("b,t", [(2, 6), (1, 5)])  # 12 rows: gather-prefill; 5 rows: LUT-GEMV
def test_llama_forward_matches_jax(name, b, t):
    jcfg, cfg, jparams, tparams = _model(name)
    ids = _ids(cfg, b, t)
    want, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids))
    got, caches = llama.forward(tparams, cfg, torch.from_numpy(ids).long())
    assert caches is None
    assert got.shape == (b, t, cfg.vocab_size)
    assert_close(got, want)


@pytest.mark.parametrize("name,kv_quantized", [("mha", True), ("mha", False), ("gqa", True)])
def test_forward_stacked_prefill_and_decode_match_jax(name, kv_quantized):
    jcfg, cfg, jparams, tparams = _model(name)
    jfused = jstacked.stack_layer_params(j_fuse(copy.deepcopy(jparams), jcfg))
    tfused = fuse_projections_codes(tparams, cfg)
    assert "qkv_proj" in tfused["layers"][0] and "gateup_proj" in tfused["layers"][0]
    tstacked = stacked.stack_layer_params(tfused)
    jfwd = jax.jit(jstacked.forward_stacked, static_argnums=(1,))

    b, t, max_len = 2, 6, 128
    ids = _ids(cfg, b, t + 6, seed=2)
    # prefill without a cache (fused gather-prefill)
    want, _ = jfwd(jfused, jcfg, jnp.asarray(ids[:, :t]))
    got, _ = stacked.forward_stacked(tstacked, cfg, torch.from_numpy(ids[:, :t]).long())
    assert_close(got, want)

    # prefill into the cache at per-row offsets, then a 6-step decode rollout
    # (fused LUT-GEMV + fused KV-write flash attention)
    jcache = jstacked.init_kv_cache(jcfg, b, max_len, quantized=kv_quantized)
    tcache = stacked.init_kv_cache(cfg, b, max_len, quantized=kv_quantized, device="cpu")
    off = np.array([0, 2], np.int32)
    want, jcache = jfwd(jfused, jcfg, jnp.asarray(ids[:, :t]), cache=jcache,
                        cache_offset=jnp.asarray(off))
    got, tcache = stacked.forward_stacked(tstacked, cfg, torch.from_numpy(ids[:, :t]).long(),
                                          cache=tcache, cache_offset=torch.from_numpy(off))
    assert_close(got, want)
    _build.reset_launch_counts()
    for step in range(6):
        pos = off + t + step
        tok = ids[:, t + step : t + step + 1]
        want, jcache = jfwd(jfused, jcfg, jnp.asarray(tok), cache=jcache,
                            cache_offset=jnp.asarray(pos))
        got, tcache = stacked.forward_stacked(tstacked, cfg, torch.from_numpy(tok).long(),
                                              cache=tcache, cache_offset=torch.from_numpy(pos))
        assert_close(got, want)
    # the CPU path runs the plain versions: no kernel was launched
    assert all(k.launches == 0 for k in _build.KERNELS.values())
    if kv_quantized:
        # int8 rows may differ by one step where a value sits on a rounding tie
        diff = np.abs(tcache.k.numpy().astype(np.int32) - np.asarray(jcache.k, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        assert_close(tcache.k_scale, jcache.k_scale, tol=1e-5)
