"""The port's serving engine and checkpoint loader against aqlm_tpu on the CPU.

Engine.generate must be greedy token-for-token identical to the JAX engine
(2x8 codes, fused projections, flash decode) over continuous batching,
chunked prefill and a prefix-cache copy; the chunks stay clear of the JAX
engine's unaligned-tail case (every chunk ends inside max_len).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import run_engine, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.io.checkpoint import save_quantized_model
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.models.stacked import init_kv_cache
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=8)


@functools.cache
def _params(mode="codes", dtype=jnp.float32):
    jcfg = jllama.ModelConfig.tiny(**CFG)
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode=mode,
                                           dtype=dtype)


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_engine_generate_matches_jax_greedy(kv_quantized):
    jcfg, jparams = _params()
    kw = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32), kv_quantized=kv_quantized)
    jengine = JEngine(jparams, jcfg, JServe(**kw))
    want, want_lp = run_engine(jengine, JSampling)

    cfg = llama.ModelConfig.tiny(**CFG)
    engine = Engine(params_from_numpy(to_numpy_tree(jparams), device="cpu"), cfg,
                    ServeConfig(**kw), device="cpu")
    got, got_lp = run_engine(engine, SamplingParams)
    assert got == want
    assert [len(g) for g in got] == [8, 4, 5]
    for g, w in zip(got_lp, want_lp):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)
    # request 2 reused request 0's prefix rows from the other slot
    assert engine.prefix_stats == jengine.prefix_stats == {"hits": 1, "tokens_reused": 20}


@pytest.mark.parametrize("mode", ["reference", "codes"])
def test_load_quantized_model_reads_jax_checkpoint(tmp_path, mode):
    jcfg, jparams = _params(mode, jnp.bfloat16)
    save_quantized_model(str(tmp_path), jparams, jcfg)
    params, cfg = load_quantized_model(str(tmp_path), device="cpu")
    assert cfg == llama.ModelConfig.tiny(**CFG)
    want = to_numpy_tree(jparams)

    def same(got, ref):
        ref = ref["__bf16__"] if isinstance(ref, dict) else ref
        got = got.view(torch.uint16) if got.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(got.numpy(), ref)

    same(params["embed"], want["embed"])
    same(params["lm_head"].weight, want["lm_head"]["weight"])
    for layer, ref in zip(params["layers"], want["layers"]):
        same(layer["input_norm"], ref["input_norm"])
        for name in ("q_proj", "down_proj"):
            q, r = layer[name], ref[name]
            assert q.mode == mode and q.scheme == AqlmScheme.parse("2x8g8")
            fields = ("codes", "codebooks", "scales") if mode == "reference" else (
                "codes_tl", "codebooks", "scales")
            for f in fields:
                same(getattr(q, f), r[f])


def test_entry_points_default_to_the_card():
    """Without device="cpu" the entry points ask for CUDA and raise here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the card")
    cfg = llama.ModelConfig.tiny(**CFG)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_quantized_params(gen, cfg, AqlmScheme.parse("2x8g8"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 128)
    params = random_quantized_params(gen, cfg, AqlmScheme.parse("2x8g8"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_quantized_model("unused")


def test_port_engine_runs_on_its_own_random_params():
    """The port's own random_quantized_params drive Engine.generate end to end."""
    cfg = llama.ModelConfig.tiny(**CFG)
    params = random_quantized_params(torch.Generator().manual_seed(0), cfg,
                                     AqlmScheme.parse("2x8g8"), dtype=torch.float32, device="cpu")
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True), device="cpu")
    out = engine.generate([np.arange(5), np.arange(37)], SamplingParams(max_new_tokens=3))
    assert [len(o) for o in out] == [3, 3]
    assert all(0 <= tok < cfg.vocab_size for o in out for tok in o)
