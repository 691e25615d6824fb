"""The Engine's batched speculative decoding against aqlm_tpu's on the CPU
(the runtime modes' scenarios: tests/test_torch_engine_spec_modes.py).

Each scenario builds one JAX Engine and one port Engine on the same numpy
params (carried by ``params_from_numpy``), a tiny Llama in f32 (GQA, every
projection's OUT a multiple of 128 so codes mode fuses), drives both
through the same calls, and is cached per module; the tests read its
results. Stated tolerances: greedy tokens, ``spec_stats``, ``prefix_stats``
and the adaptive drop's step identical; logprobs within 1e-4, but within
2e-3 (the plain engine's parity tolerance, tests/test_torch_engine_options.py)
in the phase whose prompts of 90-100 tokens fill the cache: there the plain
Engine, without a draft, already lies 3.7e-4 from JAX's (f32 sums in
another order over a hundred positions).

Drafts: ``trunc``, the target's first layer with its embedding, final norm
and head (agrees with the target often, not always); ``self``, the target
itself (accepts everything); ``dense``, an unrelated random model (accepts
next to nothing).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import engine_requests, to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import mixtral as jmixtral
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama, mixtral, stacked
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=4)
SERVE = dict(max_batch=2, max_len=128, prefill_buckets=(32,))
K = 3


@functools.cache
def _target(mode="reference"):
    jcfg = jllama.ModelConfig.tiny(**CFG)
    return jcfg, j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode=mode,
                                           dtype=jnp.float32)


def _draft(kind, jcfg, jparams):
    """(JAX draft params, draft config)."""
    if kind == "self":
        return jparams, jcfg
    if kind == "trunc":
        return {**jparams, "layers": jparams["layers"][:1]}, dataclasses.replace(jcfg, num_layers=1)
    return jllama.init_random_params(jax.random.PRNGKey(9), jcfg, dtype=jnp.float32), jcfg


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _pcfg(jcfg):
    return llama.ModelConfig.tiny(**{**CFG, "num_layers": jcfg.num_layers})


def pair_of(draft="trunc", mode="reference", **serve_kw):
    """(JAX engine, port engine) on one target and draft."""
    jcfg, jparams = _target(mode)
    jd, jdcfg = _draft(draft, jcfg, jparams)
    serve = {**SERVE, **serve_kw}
    jengine = JEngine(jparams, jcfg, JServe(**serve), draft_params=jd, draft_cfg=jdcfg, spec_k=K)
    engine = Engine(_port(jparams), _pcfg(jcfg), ServeConfig(**serve), device="cpu",
                    draft_params=_port(jd), draft_cfg=_pcfg(jdcfg), spec_k=K)
    return jengine, engine


def _drive(engine, sampling_cls, requests, abort_after=None, abort_index=0):
    """Submit ``requests`` [(prompt, SamplingParams kwargs)], step until done
    (aborting request ``abort_index`` after ``abort_after`` steps); returns
    the requests' tokens and logprobs, and spec_disabled after each step."""
    rids = [engine.submit(p, sampling_cls(**kw)) for p, kw in requests]
    flags, steps = [], 0
    while engine._pending or engine._active:
        engine.step()
        steps += 1
        flags.append(engine.spec_disabled)
        if steps == abort_after:
            assert engine.abort(rids[abort_index])
    reqs = [engine.get_request(r) for r in rids]
    return {"tokens": [r.generated for r in reqs], "logprobs": [r.logprobs for r in reqs],
            "done": [r.done for r in reqs], "disabled": flags}


def _state(engine):
    return {"spec": dict(engine.spec_stats), "prefix": dict(engine.prefix_stats),
            "offsets": [int(o) for o in engine._offsets]}


def run_both(pair, *phases):
    """Run each phase [(requests, drive kwargs)] on both engines in turn;
    per engine, the phases' results and the final state."""
    out = []
    for eng, sampling in zip(pair, (JSampling, SamplingParams)):
        out.append(([_drive(eng, sampling, reqs, **kw) for reqs, kw in phases], _state(eng)))
    return out


def requests_of(**extra):
    return [(p, dict(max_new_tokens=n, **extra)) for p, n in engine_requests()]


class _WriteRecorder:
    """Every KV row position the port's forwards write: the multi-token
    form's slices (``_write_rows``) and the single-token B8 write."""

    def __init__(self):
        self.rows, self.ends = [], []

    def __enter__(self):
        self._saved = stacked._write_rows, stacked.kv_write_inplace
        inner_rows, inner_kv = self._saved

        def rows(buf, new, offsets):
            self.ends += [(off, off + new.shape[1], buf.shape[2]) for off in offsets]
            return inner_rows(buf, new, offsets)

        def kv(cache_all, new, layer_idx, offsets):
            self.rows += [(int(o), cache_all.shape[3]) for o in offsets]
            return inner_kv(cache_all, new, layer_idx, offsets)

        stacked._write_rows, stacked.kv_write_inplace = rows, kv
        return self

    def __exit__(self, *exc):
        stacked._write_rows, stacked.kv_write_inplace = self._saved


@functools.cache
def _scenario(name):
    """{"jax": ..., "port": ...} of one scenario's phases and final state."""
    res = {}
    if name == "trunc":
        # (a) 3 requests through 2 slots, one longer than the largest bucket
        # (two prefill chunks into each cache), the third sharing a 20-token
        # prefix with the first (a prefix copy into both caches); (b) abort
        # of an active request mid-run; (c) long prompts and budgets that
        # reach the cache's room: the stop rule at max_len - (k + 2)
        rng = np.random.default_rng(11)
        long = [(rng.integers(0, 256, n), dict(max_new_tokens=60)) for n in (100, 90)]
        pair = pair_of("trunc", spec_min_acceptance=0.0)  # kept however rarely accepted
        phases = [(requests_of(), {}), (requests_of(), dict(abort_after=2, abort_index=0)),
                  (long, {})]
        with _WriteRecorder() as rec:
            (jr, js), (pr, ps) = run_both(pair, *phases)
        res["writes"] = rec
    elif name == "self":
        # (a) everything accepted; (b) an EOS inside an accepted chunk ends
        # the request at the EOS
        pair = pair_of("self")
        first = run_both(pair, (requests_of(), {}))
        tokens = first[0][0][0]["tokens"][0]
        eos = next(t for i, t in enumerate(tokens) if i >= 2 and t not in tokens[:i])
        res["eos"], res["eos_at"] = eos, tokens.index(eos)
        second = run_both(pair, ([(engine_requests()[0][0], dict(max_new_tokens=8,
                                                              eos_token_id=int(eos)))], {}))
        (jr, js), (pr, ps) = [(f[0] + s[0], s[1]) for f, s in zip(first, second)]
    elif name == "drop":
        pair = pair_of("dense", max_batch=1, spec_min_acceptance=0.3, spec_warmup=12)
        (jr, js), (pr, ps) = run_both(pair, ([(engine_requests()[0][0],
                                            dict(max_new_tokens=30))], {}))
    res.update(jax=(jr, js), port=(pr, ps))
    return res


def check_same(res: dict, long_phase: int | None = None) -> dict:
    """Hold a scenario's port results to JAX's: tokens, done flags, the
    adaptive drop's steps and the final state identical, logprobs within
    1e-4 (2e-3 in ``long_phase``, see the module's docstring)."""
    (jr, js), (pr, ps) = res["jax"], res["port"]
    assert ps == js
    for i, (j, p) in enumerate(zip(jr, pr)):
        assert p["tokens"] == j["tokens"] and p["done"] == j["done"]
        assert p["disabled"] == j["disabled"]
        tol = 2e-3 if i == long_phase else 1e-4
        for a, b in zip(p["logprobs"], j["logprobs"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    return res


def _assert_same(name):
    return check_same(_scenario(name), long_phase=2 if name == "trunc" else None)


def test_staggered_admission_and_prefix_copy_match_jax():
    res = _assert_same("trunc")
    (phase, _, _), (_, state) = res["port"][0], res["port"]
    assert [len(t) for t in phase["tokens"]] == [n for _, n in engine_requests()]
    assert state["prefix"]["hits"] >= 1
    # the trunc draft is accepted sometimes, not always
    assert 0 < state["spec"]["accepted"] < state["spec"]["proposed"]


def test_abort_mid_run_matches_jax():
    res = _assert_same("trunc")
    phase = res["port"][0][1]
    assert phase["done"] == [True, True, True]
    assert 0 < len(phase["tokens"][0]) < engine_requests()[0][1]


def test_stop_rule_keeps_every_write_inside_the_cache():
    """Both requests of phase (c) end by the room rule before their budget;
    every row the port wrote over the scenario (B8's single-token writes of
    the draft steps, an idle slot's included, and the verify forwards'
    k+1-row slices) lies inside the cache, the last round before the stop
    rule too."""
    res = _assert_same("trunc")
    phase, (_, state) = res["port"][0][2], res["port"]
    s = SERVE["max_len"]
    assert all(len(t) < 60 for t in phase["tokens"])
    assert min(state["offsets"]) >= s - (K + 2)
    rows, ends = res["writes"].rows, res["writes"].ends
    assert rows and all(0 <= off < s_len for off, s_len in rows)
    verify = [(off, end, s_len) for off, end, s_len in ends if end - off == K + 1]
    assert verify and all(0 <= off and end <= s_len for off, end, s_len in verify)
    assert max(end for _, end, _ in verify) > s - 2 * (K + 2)


def test_self_draft_accepts_all_and_eos_mid_chunk_match_jax():
    res = _assert_same("self")
    (_, state), tokens = res["port"], res["port"][0][1]["tokens"][0]
    assert state["spec"]["accepted"] == state["spec"]["proposed"] > 0
    first = res["port"][0][0]["tokens"][0]
    assert tokens == first[:res["eos_at"] + 1] and tokens[-1] == res["eos"]


def test_adaptive_drop_at_the_same_step_as_jax():
    res = _assert_same("drop")
    phase, (_, state) = res["port"][0][0], res["port"]
    assert phase["disabled"][-1] and not phase["disabled"][0]
    assert len(phase["tokens"][0]) == 30
    assert state["spec"]["proposed"] <= 12 + K


def test_refusals_match_jax():
    """JAX's assertions are the port's ValueErrors, with JAX's messages; a
    prompt past max_len - (k + 2) is refused at submit by both."""
    jcfg, jparams = _target()
    pcfg, pp = _pcfg(jcfg), _port(jparams)
    jm_cfg = jmixtral.MixtralConfig.tiny_moe(num_layers=1)
    jm = jmixtral.init_random_params(jax.random.PRNGKey(0), jm_cfg, dtype=jnp.float32)
    other = dataclasses.replace(jcfg, vocab_size=300)
    jother = jllama.init_random_params(jax.random.PRNGKey(3), other, dtype=jnp.float32)
    cases = [(jm, jm_cfg, _port(jm), mixtral.MixtralConfig.tiny_moe(num_layers=1),
              "MoE draft models are not supported"),
             (jother, other, _port(jother), dataclasses.replace(pcfg, vocab_size=300),
              "draft vocab must match")]
    for jd, jdcfg, d, dcfg, msg in cases:
        with pytest.raises(AssertionError, match=msg):
            JEngine(jparams, jcfg, JServe(**SERVE), draft_params=jd, draft_cfg=jdcfg)
        with pytest.raises(ValueError, match=msg):
            Engine(pp, pcfg, ServeConfig(**SERVE), device="cpu", draft_params=d, draft_cfg=dcfg)
    limit = SERVE["max_len"] - (K + 2)
    engine = Engine(pp, pcfg, ServeConfig(**SERVE), device="cpu", draft_params=pp, spec_k=K)
    engine.submit(np.zeros(limit, np.int64))
    with pytest.raises(ValueError, match=f"limit {limit}"):
        engine.submit(np.zeros(limit + 1, np.int64))
