"""The Engine's batched speculative decoding in the serving modes against
aqlm_tpu's on the CPU: a 2x8 codes target and draft (both fused, int8 KV
cache), and a tiny Mixtral in int8 (experts stacked, int8 head) drafted by
a one-layer Llama of its vocabulary. The scenarios and the tolerances are
tests/test_torch_engine_spec.py's (greedy tokens and every stat identical,
logprobs within 1e-4)."""

import functools

import jax
import jax.numpy as jnp
from test_torch_engine_spec import CFG, K, SERVE, check_same, pair_of, requests_of, run_both
from torch_parity import to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import mixtral as jmixtral
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize_projections
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama, mixtral
from aqlm_tpu_torch.ops.runtime import FusedCodesLinear
from aqlm_tpu_torch.serve import Engine, ServeConfig


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


@functools.cache
def _scenario(name):
    if name == "codes":
        pair = pair_of("trunc", mode="codes", kv_quantized=True, spec_min_acceptance=0.0)
        extra = {"layers": (pair[1].params["layers"], pair[1]._dparams["layers"])}
    else:
        mkw = dict(num_layers=1, hidden_size=128, intermediate_size=256, num_heads=4,
                   num_kv_heads=2)
        jmcfg = jmixtral.MixtralConfig.tiny_moe(**mkw)
        jm = jmixtral.init_random_params(jax.random.PRNGKey(0), jmcfg, dtype=jnp.float32)
        jm = j_random_quantize_projections(jax.random.PRNGKey(1), jm, SCHEME_2X8, mode="int8")
        jdcfg = jllama.ModelConfig.tiny(**{**CFG, "num_layers": 1})
        jd = jllama.init_random_params(jax.random.PRNGKey(2), jdcfg, dtype=jnp.float32)
        kw = dict(**SERVE, kv_quantized=True, lm_head_int8=True, spec_min_acceptance=0.0)
        pair = (JEngine(jm, jmcfg, JServe(**kw), draft_params=jd, draft_cfg=jdcfg, spec_k=K),
                Engine(_port(jm), mixtral.MixtralConfig.tiny_moe(**mkw), ServeConfig(**kw),
                       device="cpu", draft_params=_port(jd),
                       draft_cfg=llama.ModelConfig.tiny(**{**CFG, "num_layers": 1}), spec_k=K))
        extra = {"layers": pair[1].params["layers"], "head": pair[1].params["lm_head"]}
    (jr, js), (pr, ps) = run_both(pair, (requests_of(), {}))
    return {**extra, "jax": (jr, js), "port": (pr, ps)}


def test_codes_fused_target_and_draft_with_int8_kv_match_jax():
    res = check_same(_scenario("codes"))
    layers, dlayers = res["layers"]
    assert isinstance(layers["gateup_proj"], FusedCodesLinear)
    assert isinstance(dlayers["gateup_proj"], FusedCodesLinear)
    assert res["port"][1]["spec"]["proposed"] > 0


def test_mixtral_int8_target_with_llama_draft_matches_jax():
    res = check_same(_scenario("mixtral"))
    assert isinstance(res["layers"]["experts_gate_proj"], mixtral.StackedInt8Experts)
    assert res["head"].mode == "int8"
    assert res["port"][1]["spec"]["proposed"] > 0
