"""Speculative decoding's accept rules and ``SpeculativeDecoder`` against
aqlm_tpu on the CPU, and ``--draft_model`` in the two CLIs.

Inputs are made from numpy seeds; params cross by ``params_from_numpy``.
Stated tolerances: greedy rows' accepted counts and bonus tokens identical
to JAX's, logprobs within 1e-6; greedy decoded tokens and stats identical.
The port draws its random numbers from a ``torch.Generator``, not JAX's
keys, so a sampled path is held to distributions: the first emitted token
within total variation 0.02 of the target's distribution over 40000 trials
(JAX's own test's bound), and a self-draft accepts every proposal.
"""

import contextlib
import dataclasses
import functools
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy_tree

from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.serve.speculative import SpeculativeDecoder as JDecoder
from aqlm_tpu.serve.speculative import batched_accept as j_batched_accept
from aqlm_tpu.serve.speculative import speculative_accept as j_speculative_accept
from aqlm_tpu_torch.cli import generate, serve
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.serve import SpeculativeDecoder
from aqlm_tpu_torch.serve.speculative import batched_accept, speculative_accept

K, V = 4, 50


def _accept_inputs(b=6, seed=0):
    """logits [b, k+1, V] and proposals whose agreement with the logits'
    argmax runs 0..k positions (row r agrees for r % (k+1) positions)."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((b, K + 1, V))).astype(np.float32)
    preds = logits.argmax(-1)
    draft = rng.integers(0, V, (b, K))
    for r in range(b):
        n = r % (K + 1)
        draft[r, :n] = preds[r, :n]
        if n < K and draft[r, n] == preds[r, n]:
            draft[r, n] = (preds[r, n] + 1) % V
    q = rng.random((b, K, V)).astype(np.float32)
    return logits, draft.astype(np.int32), q / q.sum(-1, keepdims=True)


@pytest.mark.parametrize("top_k", [0, 7])
def test_batched_accept_greedy_rows_match_jax(top_k):
    """Rows 0, 2 and 5 greedy (n_acc, bonus identical; every row's lp_d and
    the greedy rows' lp_bonus within 1e-6); rows 1, 3 and 4 sampled (counts
    in [0, k], their bonus a token)."""
    logits, draft, q = _accept_inputs()
    temps = np.array([0.0, 0.8, 0.0, 1.0, 0.7, 0.0], np.float32)
    top_ps = np.array([1.0, 0.95, 0.9, 1.0, 0.8, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), len(temps))
    jn, jb, jlp_d, jlp_b = map(np.asarray, j_batched_accept(
        jnp.asarray(logits), jnp.asarray(q), jnp.asarray(draft), jnp.asarray(temps),
        jnp.asarray(top_ps), keys, k=K, top_k=top_k))
    n, bonus, lp_d, lp_b = (x.numpy() for x in batched_accept(
        torch.from_numpy(logits), torch.from_numpy(q), torch.from_numpy(draft).long(),
        torch.from_numpy(temps), torch.from_numpy(top_ps), torch.Generator().manual_seed(0),
        k=K, top_k=top_k))
    greedy = temps == 0
    np.testing.assert_array_equal(n[greedy], jn[greedy])
    np.testing.assert_array_equal(bonus[greedy], jb[greedy])
    np.testing.assert_array_equal(n[greedy], np.arange(len(temps))[greedy] % (K + 1))
    np.testing.assert_allclose(lp_d, jlp_d, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lp_b[greedy], jlp_b[greedy], rtol=0, atol=1e-6)
    assert ((n >= 0) & (n <= K)).all() and ((bonus >= 0) & (bonus < V)).all()
    # every row's lp_bonus is the raw logprob of its own (n_acc, bonus)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_allclose(lp_b, logp[np.arange(len(n)), n, bonus], rtol=0, atol=1e-6)


def test_batched_accept_all_greedy_reads_no_sampling_inputs():
    """With no sampled row the draft distributions are not needed (None)."""
    logits, draft, q = _accept_inputs()
    z = np.zeros(len(draft), np.float32)
    got = batched_accept(torch.from_numpy(logits), None, torch.from_numpy(draft).long(),
                         torch.from_numpy(z), torch.from_numpy(z + 1), None, k=K,
                         any_sampling=False)
    want = batched_accept(torch.from_numpy(logits), torch.from_numpy(q),
                          torch.from_numpy(draft).long(), torch.from_numpy(z),
                          torch.from_numpy(z + 1), torch.Generator().manual_seed(0), k=K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_speculative_accept_p_equal_q_accepts_all():
    """q == p[:k]: every proposal drawn from q is accepted (as in JAX), and
    the bonus comes from p's last row."""
    rng = np.random.default_rng(3)
    p = rng.random((K + 1, V)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    draft = np.array([rng.choice(V, p=row) for row in p[:K]], np.int32)
    jn, _ = j_speculative_accept(jnp.asarray(p), jnp.asarray(p[:K]), jnp.asarray(draft),
                                 jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        n, bonus = speculative_accept(torch.from_numpy(p), torch.from_numpy(p[:K]),
                                      torch.from_numpy(draft), gen)
        assert int(n) == int(jn) == K and 0 <= int(bonus) < V


def _tv(tokens: torch.Tensor, p: np.ndarray) -> float:
    freq = np.bincount(tokens.numpy(), minlength=len(p)) / len(tokens)
    return 0.5 * float(np.abs(freq - p).sum())


def test_accept_resample_matches_target_distribution():
    """Leviathan's theorem by sampling (tests/test_speculative.py's case,
    batched over 40000 trials in one call): drafts drawn from q, the first
    emitted token (d_1 if accepted, else the resample) distributed as p[0]."""
    vv, k, n = 7, 3, 40000
    rng = np.random.default_rng(42)
    soft = lambda x: np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    p = soft(3.0 * rng.standard_normal((k + 1, vv))).astype(np.float32)
    q = soft(3.0 * rng.standard_normal((k, vv))).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    qt = torch.from_numpy(q)[None].expand(n, k, vv)
    draft = torch.multinomial(qt.reshape(-1, vv), 1, replacement=True, generator=gen).reshape(n, k)
    n_acc, bonus = speculative_accept(torch.from_numpy(p)[None].expand(n, k + 1, vv), qt, draft,
                                      gen)
    first = torch.where(n_acc >= 1, draft[:, 0], bonus)
    assert _tv(first, p[0]) < 0.02


def test_accept_all_bonus_comes_from_last_row():
    vv, k, n = 5, 2, 20000
    rng = np.random.default_rng(3)
    p = np.exp(2.0 * rng.standard_normal((k + 1, vv)))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    pt = torch.from_numpy(p)[None].expand(n, k + 1, vv)
    draft = torch.multinomial(pt[:, :k].reshape(-1, vv), 1, replacement=True,
                              generator=gen).reshape(n, k)
    n_acc, bonus = speculative_accept(pt, pt[:, :k], draft, gen)
    assert int(n_acc.min()) == k
    assert _tv(bonus, p[k]) < 0.02


# ---------------------------------------------------------------------------
# SpeculativeDecoder against JAX's (tiny Llama, f32)
# ---------------------------------------------------------------------------


@functools.cache
def _models():
    """The target (2x8 reference mode), a random dense draft and a 1-layer
    dense draft, as JAX params."""
    cfg = jllama.ModelConfig.tiny(num_layers=2)
    target = j_random_quantized_params(jax.random.PRNGKey(0), cfg, SCHEME_2X8, mode="reference",
                                       dtype=jnp.float32)
    dense = jllama.init_random_params(jax.random.PRNGKey(9), cfg, dtype=jnp.float32)
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    one = jllama.init_random_params(jax.random.PRNGKey(1), cfg1, dtype=jnp.float32)
    return cfg, {"target": (target, cfg), "dense": (dense, cfg), "one_layer": (one, cfg1),
                 "self": (target, cfg)}


def _port(jparams):
    return params_from_numpy(to_numpy_tree(jparams), device="cpu")


def _tcfg(jcfg):
    return llama.ModelConfig.tiny(num_layers=jcfg.num_layers)


@pytest.mark.parametrize("draft,k", [("dense", 3), ("one_layer", 2), ("self", 3)])
def test_decoder_greedy_matches_jax(draft, k):
    """The self-draft accepts every proposal; its longer prompt and budget
    also run it into the cache's room (the loop stops once offset + k + 1
    reaches max_len)."""
    cfg, models = _models()
    target, _ = models["target"]
    dparams, dcfg = models[draft]
    prompt, n = np.asarray([7, 1, 4, 4, 9], np.int32), 14
    if draft == "self":
        prompt, n = np.arange(40, dtype=np.int32), 40
    want, want_stats = JDecoder(target, cfg, dparams, dcfg, k=k, max_len=64).generate(prompt, n)
    dec = SpeculativeDecoder(_port(target), _tcfg(cfg), _port(dparams), _tcfg(dcfg), k=k,
                             max_len=64, device="cpu")
    got, stats = dec.generate(prompt, n)
    assert got == want and stats == want_stats and stats["proposed"] > 0
    if draft == "self":
        assert stats["acceptance"] == 1.0 and len(got) < n
    else:
        assert len(got) == n


def test_decoder_sampled_self_draft_accepts_everything():
    """temperature > 0 with draft == target: p == q at every position up to
    the f32 rounding of two forward shapes, so every proposal is accepted."""
    cfg, models = _models()
    target, _ = models["target"]
    pt = _port(target)
    dec = SpeculativeDecoder(pt, _tcfg(cfg), pt, _tcfg(cfg), k=3, max_len=64, temperature=0.8,
                             top_p=0.95, seed=7, device="cpu")
    out, stats = dec.generate(np.asarray([3, 17, 5]), 12)
    assert len(out) == 12 and all(0 <= t < cfg.vocab_size for t in out)
    assert stats["acceptance"] == 1.0, stats


def test_decoder_refuses_other_vocabularies():
    cfg, models = _models()
    target, _ = models["target"]
    other = dataclasses.replace(_tcfg(cfg), vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocabularies must match"):
        SpeculativeDecoder(_port(target), _tcfg(cfg), _port(target), other, device="cpu")


# ---------------------------------------------------------------------------
# --draft_model in the CLIs
# ---------------------------------------------------------------------------


def test_generate_cli_with_a_draft():
    """``cli.generate random:tiny --draft_model random:tiny:1``: the JSON line
    of JAX's CLI (tokens_per_second, new_tokens, acceptance), the tokens
    the target's greedy decode (the same decoder called directly)."""
    argv = ["random:tiny", "--draft_model", "random:tiny:1", "--spec_k", "3", "--prompt",
            "1,2,3", "--max_new_tokens", "10", "--max_len", "64", "--device", "cpu",
            "--benchmark"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = generate.main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("<") and lines[0].endswith(" tokens per second>")
    line = json.loads(lines[-1])
    assert sorted(line) == ["acceptance", "new_tokens", "tokens_per_second"]
    assert line["new_tokens"] == 10 and 0.0 <= line["acceptance"] <= 1.0
    from aqlm_tpu_torch.cli.common import resolve_model

    params, cfg, _ = resolve_model("random:tiny", dtype=torch.bfloat16, device="cpu")
    dparams, dcfg, _ = resolve_model("random:tiny:1", dtype=torch.bfloat16, device="cpu")
    want, stats = SpeculativeDecoder(params, cfg, dparams, dcfg, k=3, max_len=64,
                                     device="cpu").generate(np.asarray([1, 2, 3]), 10)
    assert out["tokens"] == want and out["stats"] == stats


def test_serve_cli_with_a_draft_answers():
    """``cli.serve random:tiny --draft_model random:tiny:1``: one /generate
    request answered with its tokens, from a speculative engine."""
    args = serve.build_parser().parse_args(
        ["random:tiny", "--draft_model", "random:tiny:1", "--spec_k", "2", "--port", "0",
         "--max_batch", "2", "--max_len", "64", "--prefill_buckets", "8", "16",
         "--device", "cpu"])
    httpd, server = serve.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt_ids": [1, 2, 3], "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(req, timeout=120) as r:
            ans = json.loads(r.read())
        assert len(ans["tokens"]) == 6
        assert server.engine.spec_k == 2 and server.engine.spec_stats["proposed"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
