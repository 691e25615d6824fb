"""The unstacked forwards' contract against aqlm_tpu on the CPU: ``(logits,
caches)`` with ``kv_caches``, ``cache_offset``, ``return_hidden`` and
``remat_blocks``, for Llama, Mixtral and Falcon.

Params are built by the JAX package (f32) and carried to the port through
numpy. Stated tolerances: logits, hidden states and cache rows rtol = atol
= 2e-3 against JAX (f32; the codes layers' dequantized products sum in
another order); a prefill plus three cached decode steps against the
full-sequence forward of the same framework, 2e-3 (in codes mode 3e-2
max|logit|: the steps and the full forward take different kernels' routes,
in JAX as in the port); gradients through
``remat_blocks`` equal to those without within 1e-6 (the recomputation
runs the same ops).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import falcon as jfalcon
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import mixtral as jmixtral
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import falcon, family, llama, mixtral

LLAMA = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2)
MIXTRAL = dict(num_layers=2, hidden_size=128, intermediate_size=128, num_heads=4, num_kv_heads=2,
               num_experts=3)
FALCON = dict(num_layers=2, hidden_size=96, intermediate_size=384, num_heads=6, num_kv_heads=1)
MAX_LEN = 24


def _cfgs(family_name, **kw):
    if family_name == "llama":
        kw = {**LLAMA, **kw}
        return jllama.ModelConfig.tiny(**kw), llama.ModelConfig.tiny(**kw)
    if family_name == "mixtral":
        kw = {**MIXTRAL, **kw}
        return jmixtral.MixtralConfig.tiny_moe(**kw), mixtral.MixtralConfig.tiny_moe(**kw)
    kw = {**FALCON, **kw}
    return jfalcon.FalconConfig.tiny(**kw), falcon.FalconConfig.tiny(**kw)


@functools.cache
def _model(family_name, mode, window=None):
    """(jcfg, cfg, jparams, params): JAX's random f32 params, dense or with
    every projection but a router in 2x8 codes ``mode``, and the port's copy."""
    kw = {} if window is None else dict(sliding_window=window)
    jcfg, cfg = _cfgs(family_name, **kw)
    jmod = {"llama": jllama, "mixtral": jmixtral, "falcon": jfalcon}[family_name]
    jp = jmod.init_random_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if mode != "dense":
        jp = j_random_quantize(jax.random.PRNGKey(1), jp, SCHEME_2X8, mode=mode)
    return jcfg, cfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _ids(cfg, b, t, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _jax_forward(family_name):
    return {"llama": jllama.forward, "mixtral": jmixtral.forward}[family_name]


CACHED = [("llama", "dense", None), ("llama", "codes", None), ("llama", "reference", None),
          ("llama", "int8", None), ("llama", "dense", 5), ("mixtral", "dense", None),
          ("mixtral", "int8", None)]


@pytest.mark.parametrize("family_name,mode,window", CACHED)
def test_cached_prefill_matches_jax(family_name, mode, window):
    """A prefill into a zero cache: the logits and every layer's cache rows
    against JAX's, rows past the prefill still zero."""
    jcfg, cfg, jp, params = _model(family_name, mode, window)
    b, t = 2, 9
    ids = _ids(cfg, b, t)
    jcache = jllama.init_kv_cache(jcfg, b, MAX_LEN, dtype=jnp.float32)
    want, jnew = _jax_forward(family_name)(jp, jcfg, jnp.asarray(ids), kv_caches=jcache,
                                           cache_offset=0)
    cache = llama.init_kv_cache(cfg, b, MAX_LEN, dtype=torch.float32, device="cpu")
    got, new = family.forward_fn(cfg)(params, cfg, torch.from_numpy(ids).long(),
                                      kv_caches=cache, cache_offset=0)
    assert got.shape == (b, t, cfg.vocab_size) and len(new) == cfg.num_layers
    assert_close(got, want)
    for (k, v), (jk, jv) in zip(new, jnew):
        assert k.shape == (b, MAX_LEN, cfg.num_kv_heads, cfg.dim_per_head)
        assert_close(k, jk)
        assert_close(v, jv)
        assert bool(k[:, t:].eq(0).all()) and bool(v[:, t:].eq(0).all())


@pytest.mark.parametrize("family_name,mode,window", CACHED)
def test_prefill_and_decode_steps_equal_full_forward(family_name, mode, window):
    """A 6-token prefill and three single-token cached steps give the
    full-sequence forward's logits at every position, in the port and in
    JAX, and the two agree."""
    jcfg, cfg, jp, params = _model(family_name, mode, window)
    b, t0, steps = 2, 6, 3
    ids = _ids(cfg, b, t0 + steps, seed=4)
    fwd, jfwd = family.forward_fn(cfg), _jax_forward(family_name)
    full, caches = fwd(params, cfg, torch.from_numpy(ids).long())
    assert caches is None
    jfull, _ = jfwd(jp, jcfg, jnp.asarray(ids))
    cache = llama.init_kv_cache(cfg, b, MAX_LEN, dtype=torch.float32, device="cpu")
    jcache = jllama.init_kv_cache(jcfg, b, MAX_LEN, dtype=jnp.float32)
    got, cache = fwd(params, cfg, torch.from_numpy(ids[:, :t0]).long(), kv_caches=cache,
                     cache_offset=0)
    want, jcache = jfwd(jp, jcfg, jnp.asarray(ids[:, :t0]), kv_caches=jcache, cache_offset=0)
    outs, jouts = [got], [want]
    for p in range(t0, t0 + steps):
        got, cache = fwd(params, cfg, torch.from_numpy(ids[:, p:p + 1]).long(), kv_caches=cache,
                         cache_offset=p)
        want, jcache = jfwd(jp, jcfg, jnp.asarray(ids[:, p:p + 1]), kv_caches=jcache,
                            cache_offset=p)
        outs.append(got)
        jouts.append(want)
    stepped = torch.cat(outs, dim=1)
    jstepped = np.concatenate([np.asarray(j) for j in jouts], axis=1)
    assert_close(stepped, jstepped)
    if mode == "codes":
        # the single-token steps take the LUT GEMV over f32 codebook values,
        # the 18-row forward the gather-prefill GEMM over bf16-rounded
        # weights, in JAX as here: within the repo's 3e-2 max|logit| limit
        for a, b in ((stepped, full), (jstepped, jfull)):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max()
    else:
        assert_close(stepped, full)
        assert_close(jstepped, jfull)


@pytest.mark.parametrize("family_name,mode", [("llama", "dense"), ("llama", "codes"),
                                              ("mixtral", "dense"), ("mixtral", "int4"),
                                              ("falcon", "dense"), ("falcon", "codes")])
def test_uncached_forward_returns_logits_and_none_as_jax(family_name, mode):
    jcfg, cfg, jp, params = _model(family_name, mode)
    ids = _ids(cfg, 2, 7)
    jmod = {"llama": jllama, "mixtral": jmixtral, "falcon": jfalcon}[family_name]
    want, jcaches = jmod.forward(jp, jcfg, jnp.asarray(ids))
    got, caches = family.forward_fn(cfg)(params, cfg, torch.from_numpy(ids).long())
    assert caches is None and jcaches is None
    assert_close(got, want)


@pytest.mark.parametrize("family_name,mode", [("llama", "dense"), ("llama", "int4"),
                                              ("falcon", "dense"), ("falcon", "codes")])
def test_return_hidden_matches_jax(family_name, mode):
    """The post-final-norm hidden state (llama: also with a cache), and the
    head applied to it gives the logits."""
    jcfg, cfg, jp, params = _model(family_name, mode)
    ids = _ids(cfg, 2, 7)
    jmod = {"llama": jllama, "falcon": jfalcon}[family_name]
    want, _ = jmod.forward(jp, jcfg, jnp.asarray(ids), return_hidden=True)
    got, caches = family.forward_fn(cfg)(params, cfg, torch.from_numpy(ids).long(),
                                         return_hidden=True)
    assert got.shape == (2, 7, cfg.hidden_size) and caches is None
    assert_close(got, want)
    assert_close(llama.head(got, params, cfg),
                 family.forward_fn(cfg)(params, cfg, torch.from_numpy(ids).long())[0])
    if family_name == "llama":
        jcache = jllama.init_kv_cache(jcfg, 2, MAX_LEN, dtype=jnp.float32)
        want, _ = jllama.forward(jp, jcfg, jnp.asarray(ids), kv_caches=jcache, cache_offset=0,
                                 return_hidden=True)
        cache = llama.init_kv_cache(cfg, 2, MAX_LEN, dtype=torch.float32, device="cpu")
        got, new = llama.forward(params, cfg, torch.from_numpy(ids).long(), kv_caches=cache,
                                 cache_offset=0, return_hidden=True)
        assert new is cache
        assert_close(got, want)


def test_mixtral_return_hidden_is_the_normed_state_before_the_head():
    _, cfg, _, params = _model("mixtral", "dense")
    ids = torch.from_numpy(_ids(cfg, 1, 5)).long()
    hidden, _ = mixtral.forward(params, cfg, ids, return_hidden=True)
    assert torch.equal(llama.head(hidden, params, cfg), mixtral.forward(params, cfg, ids)[0])


def _grads(fwd, params, cfg, ids, remat):
    """Gradients of the mean logit square with respect to the embedding and
    every layer's first norm weight."""
    leaves = [params["embed"]] + [layer["input_norm"] for layer in params["layers"]]
    for x in leaves:
        x.grad = None
        x.requires_grad_(True)
    logits, _ = fwd(params, cfg, ids, remat_blocks=remat)
    logits.float().pow(2).mean().backward()
    out = [x.grad.clone() for x in leaves]
    for x in leaves:
        x.requires_grad_(False)
        x.grad = None
    return out


@pytest.mark.parametrize("family_name,mode", [("llama", "dense"), ("llama", "codes"),
                                              ("llama", "reference"), ("mixtral", "dense"),
                                              ("falcon", "dense")])
def test_remat_blocks_gradients_equal_plain(family_name, mode):
    """``remat_blocks`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same gradients as without it."""
    _, cfg, _, params = _model(family_name, mode)
    ids = torch.from_numpy(_ids(cfg, 2, 6)).long()
    fwd = family.forward_fn(cfg)
    plain = _grads(fwd, params, cfg, ids, False)
    remat = _grads(fwd, params, cfg, ids, True)
    assert any(float(g.abs().max()) > 0 for g in plain)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(fwd(params, cfg, ids, remat_blocks=True)[0], fwd(params, cfg, ids)[0])


def test_init_kv_cache_matches_jax_layout():
    jcfg, cfg = _cfgs("llama")
    jcache = jllama.init_kv_cache(jcfg, 3, 10)
    cache = llama.init_kv_cache(cfg, 3, 10, device="cpu")
    assert len(cache) == len(jcache) == cfg.num_layers
    for (k, v), (jk, _) in zip(cache, jcache):
        assert tuple(k.shape) == tuple(jk.shape) == tuple(v.shape)
        assert k.dtype == torch.bfloat16 and bool(k.eq(0).all())


def test_family_forward_fn_names_each_family_forward():
    for name, mod in (("llama", llama), ("mixtral", mixtral), ("falcon", falcon)):
        assert family.forward_fn(_cfgs(name)[1]) is mod.forward
