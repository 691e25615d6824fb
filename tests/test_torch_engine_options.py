"""The Engine's options and the decode path's flash switch against aqlm_tpu
on the CPU: ``forward_stacked(use_flash_decode=...)``, ``ServeConfig``'s
fields, ``decode_chunk``, ``prefix_cache``, ``use_flash_decode`` and
``Engine.abort``.

Tolerances: logits rtol = atol = 2e-3 (f32 params, the engine tests'
tolerance); greedy tokens identical; logprobs within 2e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, engine_requests, run_engine, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import stacked as jstacked
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama, stacked
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig
from aqlm_tpu_torch.serve.sampler import sample_tokens

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=4)
SERVE = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=True)


@functools.cache
def _params(mode):
    jcfg = jllama.ModelConfig.tiny(**CFG)
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode=mode,
                                           dtype=jnp.float32)


def _engines(mode, **kw):
    jcfg, jparams = _params(mode)
    serve = {**SERVE, **kw}
    return (JEngine(jparams, jcfg, JServe(**serve)),
            Engine(params_from_numpy(to_numpy_tree(jparams), device="cpu"),
                   llama.ModelConfig.tiny(**CFG), ServeConfig(**serve), device="cpu"))


def _same_lps(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kv_quantized", [True, False])
@pytest.mark.parametrize("use_flash", [None, True, False])
@pytest.mark.parametrize("mode", ["codes", "int8"])
def test_forward_stacked_use_flash_decode_matches_jax(mode, use_flash, kv_quantized, monkeypatch):
    """Prefill at per-row offsets, then three decode steps. At max_len 128 the
    default rule takes K3 for codes layers and not for int8 ones; True and
    False force it either way. Without K3 a decode step writes its rows with
    B8 (kv_write4 for the int8 cache, kv_write per array for bf16)."""
    jcfg, jparams = _params(mode)
    cfg = llama.ModelConfig.tiny(**CFG)
    jst = jstacked.stack_layer_params(jparams)
    st = stacked.stack_layer_params(params_from_numpy(to_numpy_tree(jparams), device="cpu"))
    jfwd = jax.jit(jstacked.forward_stacked, static_argnums=(1,),
                   static_argnames=("use_flash_decode",))
    calls = {"k3": 0, "kv_write": 0, "kv_write4": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(stacked, "flash_decode_write_attention_indexed",
                        counted("k3", stacked.flash_decode_write_attention_indexed))
    monkeypatch.setattr(stacked, "kv_write_inplace", counted("kv_write", stacked.kv_write_inplace))
    monkeypatch.setattr(stacked, "kv_write4_inplace",
                        counted("kv_write4", stacked.kv_write4_inplace))

    b, t, max_len = 2, 6, 128
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t + 3))
    jcache = jstacked.init_kv_cache(jcfg, b, max_len, quantized=kv_quantized)
    cache = stacked.init_kv_cache(cfg, b, max_len, quantized=kv_quantized, device="cpu")
    off = np.array([0, 2], np.int32)
    for step in range(4):
        sl = slice(0, t) if step == 0 else slice(t + step - 1, t + step)
        pos = off if step == 0 else off + t + step - 1
        want, jcache = jfwd(jst, jcfg, jnp.asarray(ids[:, sl]), cache=jcache,
                            cache_offset=jnp.asarray(pos), use_flash_decode=use_flash)
        got, cache = stacked.forward_stacked(st, cfg, torch.from_numpy(ids[:, sl]), cache=cache,
                                             cache_offset=torch.from_numpy(pos),
                                             use_flash_decode=use_flash)
        assert_close(got, want)
    flash = use_flash if use_flash is not None else mode == "codes"
    writes = 3 * cfg.num_layers  # decode forwards x layers
    assert calls["k3"] == (writes if flash else 0)
    assert calls["kv_write4"] == (0 if flash or not kv_quantized else writes)
    assert calls["kv_write"] == (0 if flash or kv_quantized else 2 * writes)


def test_serve_config_fields_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(ServeConfig) == names(JServe)
    defaults = lambda cls: {f.name: f.default for f in dataclasses.fields(cls)}
    assert defaults(ServeConfig) == defaults(JServe)


@pytest.mark.parametrize("mode", ["codes", "int8"])
@pytest.mark.parametrize("decode_chunk", [1, 3, 4])
def test_engine_decode_chunk_matches_jax(decode_chunk, mode):
    """Chunks run once nothing is pending (request 2 waits for a slot), are
    cut to the longest remaining budget, and drop the tail of a request that
    ends inside them."""
    jengine, engine = _engines(mode, decode_chunk=decode_chunk)
    chunks = []
    inner = engine._decode_steps
    engine._decode_steps = lambda bucket, n: chunks.append(n) or inner(bucket, n)
    want, want_lp = run_engine(jengine, JSampling)
    got, got_lp = run_engine(engine, SamplingParams)
    # chunks of decode_chunk steps, the last cut to the longest remaining budget
    assert max(chunks) == decode_chunk and (decode_chunk == 1 or 1 in chunks)
    assert got == want and [len(g) for g in got] == [n for _, n in engine_requests()]
    _same_lps(got_lp, want_lp)
    assert engine.prefix_stats == jengine.prefix_stats == {"hits": 1, "tokens_reused": 20}
    np.testing.assert_array_equal(engine._offsets, jengine._offsets)


@pytest.mark.parametrize("kw", [dict(prefix_cache=False), dict(use_flash_decode=True),
                                dict(use_flash_decode=False)],
                         ids=["no_prefix_cache", "flash_on", "flash_off"])
def test_engine_options_match_jax(kw):
    jengine, engine = _engines("int8", **kw)
    want, want_lp = run_engine(jengine, JSampling)
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    _same_lps(got_lp, want_lp)
    hits = {"hits": 0, "tokens_reused": 0} if kw.get("prefix_cache") is False else {
        "hits": 1, "tokens_reused": 20}
    assert engine.prefix_stats == jengine.prefix_stats == hits


@pytest.mark.parametrize("which", ["pending", "active"])
def test_engine_abort_matches_jax(which):
    """Two of the three requests fill the slots at the first step; the third
    waits. Aborting the waiting one drops it; aborting an active one frees
    its slot for the waiting one. A second abort, or one of an unknown id,
    returns False."""
    results = []
    for eng, sampling in zip(_engines("codes"), (JSampling, SamplingParams)):
        rids = [eng.submit(p, sampling(max_new_tokens=n)) for p, n in engine_requests()]
        eng.step()
        victim = rids[2] if which == "pending" else rids[0]
        answers = [eng.abort(victim), eng.abort(victim), eng.abort(99)]
        while eng._pending or eng._active:
            eng.step()
        reqs = [eng.get_request(r) for r in rids]
        results.append((answers, [r.generated for r in reqs], [r.logprobs for r in reqs],
                        [r.done for r in reqs], eng.prefix_stats))
    (j_ans, want, want_lp, j_done, j_stats), (ans, got, got_lp, done, stats) = results
    assert ans == j_ans == [True, False, False]
    assert got == want and done == j_done == [True, True, True]
    _same_lps(got_lp, want_lp)
    assert stats == j_stats
    if which == "pending":
        assert got[2] == []
    else:
        assert len(got[0]) == 2 and len(got[2]) == 5


@pytest.mark.parametrize("temps", [[0.0, 0.0, 0.0], [0.0, 0.7, 1.0]])
def test_sample_tokens_host_flag_keeps_the_result(temps):
    """Told on the host whether any row samples, sample_tokens returns what it
    returns when it reads that from the temperatures."""
    logits = torch.randn((3, 50), generator=torch.Generator().manual_seed(0))
    temperature, top_p = torch.tensor(temps), torch.full((3,), 0.9)
    want = sample_tokens(logits, torch.Generator().manual_seed(1), temperature, top_p, top_k=5)
    got = sample_tokens(logits, torch.Generator().manual_seed(1), temperature, top_p, top_k=5,
                        any_sampling=any(x > 0 for x in temps))
    assert torch.equal(got, want)
