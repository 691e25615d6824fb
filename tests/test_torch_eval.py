"""The port's evaluation (data.eval, data.scoring, data.loaders, cli.evaluate,
cli.quantize --eval_datasets) against aqlm_tpu on the CPU.

One canonical checkpoint (a tiny Llama in 2x8 codes, f32, random weights
from JAX) is written by the JAX package once per module; both sides load it
and transcode it to each runtime mode at load. Stated tolerances:
perplexities within 1e-4 relative of JAX's; score sums within 1e-4
(absolute, on sums of a few log-probabilities), greedy flags identical;
the preprocessing helpers identical.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqlm_tpu.cli import evaluate as jcli_evaluate
from aqlm_tpu.config import SCHEME_2X8
from aqlm_tpu.data import eval as jeval
from aqlm_tpu.data import loaders as jloaders
from aqlm_tpu.data import scoring as jscoring
from aqlm_tpu.io import load_quantized_model as j_load
from aqlm_tpu.io import save_quantized_model as j_save
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import convert_runtime_mode as j_convert
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu_torch.cli import evaluate as cli_evaluate
from aqlm_tpu_torch.cli import quantize as cli_quantize
from aqlm_tpu_torch.data import eval as peval
from aqlm_tpu_torch.data import loaders, scoring
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import convert_runtime_mode

CFG = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4)
MODES = ("reference", "codes", "int8", "int4")
SEQLEN = 24


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eval") / "canonical")
    jcfg = jllama.ModelConfig.tiny(**CFG)
    jp = j_random_quantized_params(jax.random.PRNGKey(0), jcfg, SCHEME_2X8, mode="reference",
                                   dtype=jnp.float32)
    j_save(path, jp, jcfg)
    return path


@functools.cache
def _models(path, mode):
    """(JAX params, cfg, port params, cfg) of the checkpoint in ``mode``."""
    jp, jcfg = j_load(path)
    params, cfg = load_quantized_model(path, device="cpu")
    return j_convert(jp, mode), jcfg, convert_runtime_mode(params, mode), cfg


def _ids(n, seqlen=SEQLEN, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(n, seqlen)).astype(np.int32)


@pytest.mark.parametrize("batch_size", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_evaluate_perplexity_matches_jax(ckpt, mode, batch_size):
    """Four windows: at batch 3 the second batch holds one real row and two
    padded ones, whose sums are dropped."""
    jp, jcfg, params, cfg = _models(ckpt, mode)
    ids = _ids(4)
    want = jeval.evaluate_perplexity(jp, jcfg, ids, batch_size=batch_size)
    got = peval.evaluate_perplexity(params, cfg, ids, batch_size=batch_size)
    assert np.isfinite(got) and got > 1
    assert got == pytest.approx(want, rel=1e-4)


def test_padded_rows_do_not_move_perplexity(ckpt):
    _, _, params, cfg = _models(ckpt, "reference")
    ids = _ids(4)
    one = peval.evaluate_perplexity(params, cfg, ids, batch_size=1)
    assert peval.evaluate_perplexity(params, cfg, ids, batch_size=3) == pytest.approx(one, rel=1e-6)
    assert peval.evaluate_perplexity(params, cfg, ids, batch_size=8) == pytest.approx(one, rel=1e-6)


def _greedy_continuation(params, cfg, ctx, n):
    """n greedy tokens after ctx by the port's own forward."""
    seq = list(ctx)
    for _ in range(n):
        logits, _ = llama.forward(params, cfg, torch.tensor([seq]))
        seq.append(int(logits[0, -1].argmax()))
    return np.asarray(seq[len(ctx):], np.int32)


@pytest.mark.parametrize("mode", ["reference", "codes"])
def test_score_batch_matches_jax(ckpt, mode):
    """Contexts and continuations of several lengths (padded to the
    longest), one greedy continuation among them."""
    jp, jcfg, params, cfg = _models(ckpt, mode)
    rng = np.random.default_rng(7)
    ctxs = [rng.integers(0, 256, n).astype(np.int32) for n in (3, 7, 5, 4)]
    conts = [rng.integers(0, 256, n).astype(np.int32) for n in (2, 1, 4)]
    conts.append(_greedy_continuation(params, cfg, ctxs[3], 3))
    want = jscoring.score_batch(jp, jcfg, ctxs, conts)
    got = scoring.score_batch(params, cfg, ctxs, conts)
    assert [g for _, g in got] == [g for _, g in want]
    assert got[3][1] and not any(g for _, g in got[:3])
    for (a, _), (b, _) in zip(got, want):
        assert a == pytest.approx(b, abs=1e-4)
    padded = scoring.score_batch(params, cfg, ctxs, conts, pad_len=16)
    for (a, _), (b, _) in zip(padded, got):
        assert a == pytest.approx(b, abs=1e-4)


def test_score_loglikelihood_matches_jax(ckpt):
    jp, jcfg, params, cfg = _models(ckpt, "int8")
    ctx, cont = np.arange(5, 11, dtype=np.int32), np.asarray([9, 200, 3], np.int32)
    want = jscoring.score_loglikelihood(jp, jcfg, ctx, cont)
    got = scoring.score_loglikelihood(params, cfg, ctx, cont)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], abs=1e-4)


@pytest.mark.parametrize("max_chars", [1, 4, 10, 100])
def test_split_long_texts_matches_jax(max_chars):
    texts = ["", "a", "hello world, a longer document", "x" * 23]
    assert loaders.split_long_texts(texts, max_chars) == jloaders.split_long_texts(texts, max_chars)


@pytest.mark.parametrize("add_labels", [False, True])
@pytest.mark.parametrize("seqlen", [1, 4, 7])
def test_group_texts_matches_jax(seqlen, add_labels):
    docs = [[1, 2, 3], np.arange(10), [], [[4, 5], [6, 7]]]
    got = loaders.group_texts(docs, seqlen, add_labels=add_labels)
    want = jloaders.group_texts(docs, seqlen, add_labels=add_labels)
    if add_labels:
        assert set(got) == set(want) == {"input_ids", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        assert got["labels"] is not got["input_ids"]
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_get_loaders_eval_mode_matches_jax_and_hf_names_raise(tmp_path):
    kw = dict(nsamples=3, seqlen=8, vocab_size=100, seed=2, eval_mode=True)
    assert np.array_equal(loaders.get_loaders("random", **kw), jloaders.get_loaders("random", **kw))
    path = str(tmp_path / "ids.npy")
    np.save(path, np.arange(50))
    assert np.array_equal(loaders.get_loaders(path, **kw), jloaders.get_loaders(path, **kw))
    with pytest.raises(NotImplementedError, match="A11"):
        loaders.get_loaders("wikitext2", tokenizer=object(), **kw)


def test_sharded_eval_and_harness_adapter_raise():
    with pytest.raises(NotImplementedError, match="A14"):
        peval.evaluate_perplexity_sharded({}, None, np.zeros((2, 4)), None)
    with pytest.raises(NotImplementedError, match="A11"):
        scoring.make_lm_eval_adapter({}, None, None)


EVAL_ARGS = ["--datasets", "random", "--nsamples", "3", "--model_seqlen", str(SEQLEN),
             "--batch_size", "2"]


@pytest.mark.parametrize("mode", MODES)
def test_evaluate_cli_matches_jax_cli(ckpt, mode, capsys):
    want = jcli_evaluate.main([ckpt, *EVAL_ARGS, "--mode", mode])
    jout = capsys.readouterr().out.strip().splitlines()
    got = cli_evaluate.main([ckpt, *EVAL_ARGS, "--mode", mode, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert set(got) == set(want) == {"model", "kind", "ppl_random"}
    assert got["kind"] == want["kind"] == "quantized"
    assert got["ppl_random"] == pytest.approx(want["ppl_random"], rel=1e-4)
    assert json.loads(out[-1]) == got
    assert len(out) == len(jout) == 2 and out[0].startswith("random perplexity: ")


def test_evaluate_cli_skips_harness_tasks_without_lm_eval(ckpt, capsys):
    got = cli_evaluate.main([ckpt, *EVAL_ARGS, "--device", "cpu", "--tasks", "hellaswag"])
    out = capsys.readouterr().out
    assert "lm_eval not installed; skipping harness tasks" in out
    assert "lm_eval" not in got
    with pytest.raises(NotImplementedError, match="A14"):
        cli_evaluate.main([ckpt, *EVAL_ARGS, "--device", "cpu", "--mesh_data", "2"])


QUANTIZE_ARGS = ["random:tiny", "random", "--nsamples", "4", "--model_seqlen", "16",
                 "--num_codebooks", "2", "--nbits_per_codebook", "8", "--in_group_size", "8",
                 "--max_epochs", "2", "--steps_per_epoch", "2", "--init_max_iter", "5",
                 "--finetune_max_epochs", "1", "--eval_nsamples", "3", "--device", "cpu"]


def test_quantize_cli_eval_datasets_matches_jax_on_its_checkpoint(tmp_path, capsys):
    """The port's quantize CLI evaluates its calibrated model after the save
    (ids from seed + 1, as in aqlm_tpu); JAX's evaluation of the saved
    checkpoint on the same ids gives the same perplexity."""
    save = str(tmp_path / "q")
    stats = cli_quantize.main([*QUANTIZE_ARGS, "--eval_datasets", "random", "--save", save])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ppl_random"] == stats["ppl_random"]
    jp, jcfg = j_load(save)
    ids = jloaders.get_loaders("random", 3, 16, vocab_size=jcfg.vocab_size, seed=1, eval_mode=True)
    want = jeval.evaluate_perplexity(jp, jcfg, ids)
    assert np.isfinite(stats["ppl_random"])
    assert stats["ppl_random"] == pytest.approx(want, rel=1e-4)
