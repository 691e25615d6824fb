"""The port's calibration (aqlm_tpu_torch.calib, cli.quantize) against aqlm_tpu on the CPU.

Same numpy inputs through both, at small sizes. Stated tolerances:

- XTXAccumulator over several batches: rtol 1e-6 against JAX's and against
  a float64 sum.
- k-means from the same initial centroids (JAX's own draw passed in; the
  two frameworks draw other numbers from one seed), the greedy init,
  find_nearest_cluster and the 1-D k-means: assignments identical,
  centroids rtol 1e-5 (one case with duplicate initial centroids, ties to
  the lowest index in both; the 1-D k-means also atol 1e-5: its centroids
  are differences of prefix sums, whose error is absolute).
- beam search from the same inputs and visit order, beam 1 and 4 (one
  codebook with two equal rows): codes identical.
- one AMSGrad epoch from the same start: codebooks and scales rtol 1e-5.
- quantize_weight end to end (64x128, 2x8): final MSE below the init's and
  within 10% of JAX's (the k-means inits are drawn differently).
- finetune_block, one epoch from the same block and data: params rtol 1e-4.
- quantize_model on a tiny 2-layer Llama carried across: each layer's
  out_loss within 10% of JAX's (again other k-means draws).
- the port's saved checkpoint, loaded by aqlm_tpu's loader: arrays
  byte-identical, the same model config; served greedy in codes mode by both
  engines: identical tokens.
- cli.quantize.main(..., "--device", "cpu") at random:tiny in 2x8: the same
  avg_bits as JAX's CLI; its save loads in aqlm_tpu.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import to_numpy_tree

from aqlm_tpu.calib import blockwise as jbw
from aqlm_tpu.calib import engine as jeng
from aqlm_tpu.calib import kmeans as jkm
from aqlm_tpu.calib import pipeline as jpipe
from aqlm_tpu.calib.beam_search_xtx import beam_search_optimal_codes as j_beam
from aqlm_tpu.cli import quantize as jcli
from aqlm_tpu.config import SCHEME_2X8 as J2X8
from aqlm_tpu.io.checkpoint import load_quantized_model as j_load
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import convert_runtime_mode as j_convert
from aqlm_tpu.ops.dequant import AqlmWeight as JWeight
from aqlm_tpu.ops.runtime import QuantizedLinear as JQL
from aqlm_tpu.serve import Engine as JEngine
from aqlm_tpu.serve import SamplingParams as JSampling
from aqlm_tpu.serve import ServeConfig as JServe
from aqlm_tpu_torch.calib import beam_search_xtx as bs
from aqlm_tpu_torch.calib import blockwise as bw
from aqlm_tpu_torch.calib import engine as eng
from aqlm_tpu_torch.calib import kmeans as km
from aqlm_tpu_torch.calib import pipeline as pipe
from aqlm_tpu_torch.cli import quantize as cli
from aqlm_tpu_torch.config import SCHEME_2X8
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io import load_quantized_model, save_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import convert_runtime_mode
from aqlm_tpu_torch.ops.dequant import AqlmWeight
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

T = torch.from_numpy


def test_xtx_accumulator_matches_jax_and_float64():
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((2, 17, 48)) * 3 + 1).astype(np.float32) for _ in range(6)]
    acc, jacc = eng.XTXAccumulator.zeros(48), jeng.XTXAccumulator.zeros(48)
    for b in batches:
        acc, jacc = acc.add(T(b)), jacc.add(jnp.asarray(b))
    x64 = np.concatenate([b.reshape(-1, 48) for b in batches]).astype(np.float64)
    want64 = x64.T @ x64 / x64.shape[0]
    assert acc.nsamples == 6 * 34
    np.testing.assert_allclose(acc.mean.numpy(), np.asarray(jacc.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(acc.mean.numpy(), want64, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,k,d", [(600, 32, 8), (200, 256, 8)])  # n < k: duplicate draws
def test_fit_kmeans_from_jax_init_matches_jax(n, k, d):
    rng = np.random.default_rng(n)
    data = rng.standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.choice(key, n, shape=(k,), replace=n < k))
    if n < k:
        assert len(set(perm.tolist())) < k  # equal initial centroids: ties in the assignment
    jc, jidx, jrest = jkm.fit_kmeans(jnp.asarray(data), k, key=key, max_iter=20)
    c, idx, rest = km._fit_kmeans_from(T(data), T(data[perm]), max_iter=20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rest.numpy(), np.asarray(jrest), rtol=1e-5, atol=1e-6)


def test_greedy_init_and_find_nearest_cluster_match_jax():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((300, 8)).astype(np.float32)
    want = np.asarray(jkm._greedy_init(jnp.asarray(data), 16))
    got = km._greedy_init(T(data), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    clusters = np.concatenate([want, want[:3]])  # duplicate rows: the lower index wins in both
    jidx, jrest = jkm.find_nearest_cluster(jnp.asarray(data), jnp.asarray(clusters))
    idx, rest = km.find_nearest_cluster(T(data), T(clusters), chunk=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rest.numpy(), np.asarray(jrest))


@pytest.mark.parametrize("k,offset_rate", [(4, 0.0), (16, 0.1)])
def test_fit_kmeans_1d_matches_jax(k, offset_rate):
    rng = np.random.default_rng(k)
    data = rng.standard_normal((12, 64)).astype(np.float32)
    jc, jidx, jrest = jkm.fit_kmeans_1d(jnp.asarray(data), k, offset_rate=offset_rate)
    c, idx, rest = km.fit_kmeans_1d(T(data), k, offset_rate=offset_rate)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # a centroid is a difference of two prefix sums (summed in another order
    # by XLA): its error is absolute, ~eps * |prefix sum|, hence the atol
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rest.numpy(), np.asarray(jrest), rtol=1e-5, atol=1e-5)


def _beam_inputs(seed, out_f=32, in_f=64, K=2, S=16, g=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, in_f)).astype(np.float32)
    xtx = (x.T @ x / 256).astype(np.float32)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    cb = (rng.standard_normal((K, S, 1, g)) * 0.5).astype(np.float32)
    cb[1, 5] = cb[1, 2]  # two equal rows: equal candidate scores
    codes = rng.integers(0, S, (out_f, in_f // g, K)).astype(np.uint8)
    scales = (rng.random(out_f) + 0.5).astype(np.float32)
    order = np.stack([np.repeat(rng.permutation(in_f // g), K),
                      np.concatenate([rng.permutation(K) for _ in range(in_f // g)])], 1)
    return xtx, w, cb, codes, scales, order.astype(np.int32)


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_matches_jax(beam):
    xtx, w, cb, codes, scales, order = _beam_inputs(beam)
    jcodes, jloss = j_beam(jnp.asarray(xtx), jnp.asarray(w), jnp.asarray(cb), jnp.asarray(codes),
                           jnp.asarray(scales), beam_size=beam, steps_order=jnp.asarray(order))
    got, loss = bs.beam_search_optimal_codes(T(xtx), T(w), T(cb), T(codes), T(scales),
                                             beam_size=beam, steps_order=order)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4, atol=1e-4)
    err = bs.channelwise_squared_error(T(xtx), T(w), T(w) + 1)
    np.testing.assert_allclose(err.numpy(), np.full(32, xtx.sum()), rtol=1e-5)


def _start(seed=0, out_f=64, in_f=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((512, in_f)).astype(np.float32)
    xtx = (x.T @ x / 512).astype(np.float32)
    w = (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)
    return w, xtx


def test_one_amsgrad_epoch_matches_jax():
    w, xtx = _start(1)
    jw = jeng.init_quantized_weight(jnp.asarray(w), J2X8, key=jax.random.PRNGKey(0), max_iter=5)
    codes, cb0, sc0 = (np.array(a) for a in (jw.codes, jw.codebooks, jw.scales))
    cfg = jeng.CalibConfig(lr=1e-3)
    opt = optax.amsgrad(cfg.lr, b1=0.0, b2=0.95)
    params = (jnp.asarray(cb0), jnp.asarray(sc0))
    state = opt.init(params)

    def jloss(p):
        return jeng.compute_mse(JWeight(codes=jnp.asarray(codes), codebooks=p[0], scales=p[1],
                                        bias=None, scheme=J2X8), jnp.asarray(w), jnp.asarray(xtx))

    cb = T(cb0.copy()).requires_grad_(True)
    sc = T(sc0.copy()).requires_grad_(True)
    topt = eng._AMSGrad([cb, sc], cfg.lr, b1=0.0, b2=0.95)
    for _ in range(5):
        loss, grads = jax.value_and_grad(jloss)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tw = AqlmWeight(codes=T(codes), codebooks=cb, scales=sc, bias=None, scheme=SCHEME_2X8)
        tloss = eng.compute_mse(tw, T(w), T(xtx))
        np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
        topt.step(torch.autograd.grad(tloss, [cb, sc]))
    np.testing.assert_allclose(cb.detach().numpy(), np.asarray(params[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(params[1]), rtol=1e-5, atol=1e-7)


def test_quantize_weight_end_to_end_near_jax():
    w, xtx = _start(2)
    cfg = dict(lr=1e-3, max_epochs=3, steps_per_epoch=10, relative_mse_tolerance=None,
               init_max_iter=10)
    _, jstats = jeng.quantize_weight(jnp.asarray(w), jnp.asarray(xtx), J2X8,
                                     jeng.CalibConfig(**cfg))
    q, stats = eng.quantize_weight(T(w), T(xtx), SCHEME_2X8, eng.CalibConfig(**cfg))
    assert q.codes.dtype == torch.uint8 and q.codes.shape == (64, 16, 2)
    assert stats["adam_steps"] == 30 and len(stats["loss_history"]) == 3
    assert stats["final_mse"] < stats["init_mse"]
    assert abs(stats["final_mse"] - jstats["final_mse"]) <= 0.1 * jstats["final_mse"]


def _block(seed=0):
    jcfg = jllama.ModelConfig.tiny(num_layers=1)
    jp = jllama.init_random_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    layer = jp["layers"][0]
    rng = np.random.default_rng(seed)
    for name in ("q_proj", "down_proj"):  # two reference-mode projections among dense ones
        o, i = layer[name].weight.shape
        jw = JWeight(codes=jnp.asarray(rng.integers(0, 256, (o, i // 8, 2)).astype(np.uint8)),
                     codebooks=jnp.asarray(rng.standard_normal((2, 256, 1, 8)).astype(np.float32)
                                           * 0.05),
                     scales=jnp.asarray((rng.random(o) + 0.5).astype(np.float32)), bias=None,
                     scheme=J2X8)
        layer[name] = JQL.from_aqlm(jw, mode="reference")
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return jcfg, layer, x, y


def test_finetune_block_one_epoch_matches_jax():
    jcfg, jlayer, x, y = _block()
    fcfg = dict(lr=1e-3, max_epochs=1, batch_size=2)
    jout = jbw.finetune_block(jlayer, jcfg, jnp.asarray(x), jnp.asarray(y),
                              jbw.BlockFinetuneConfig(**fcfg))
    layer = params_from_numpy(to_numpy_tree(jlayer), device="cpu")
    out = bw.finetune_block(layer, llama.ModelConfig.tiny(num_layers=1), T(x), T(y),
                            bw.BlockFinetuneConfig(**fcfg))
    want = to_numpy_tree(jout)
    for name in ("q_proj", "down_proj"):
        for f in ("codebooks", "scales"):
            np.testing.assert_allclose(getattr(out[name], f).detach().numpy(), want[name][f],
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(out[name].codes.numpy(), want[name]["codes"])
    for name in ("input_norm", "post_attn_norm"):
        np.testing.assert_allclose(out[name].detach().numpy(), want[name], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["o_proj"].weight.detach().numpy(), want["o_proj"]["weight"],
                               rtol=1e-4, atol=1e-6)
    assert not np.array_equal(want["input_norm"], np.ones(64, np.float32))  # it trained


CLI_ARGS = ["random:tiny", "random", "--nsamples", "4", "--model_seqlen", "16",
            "--num_codebooks", "2", "--nbits_per_codebook", "8", "--in_group_size", "8",
            "--max_epochs", "2", "--steps_per_epoch", "2", "--init_max_iter", "5",
            "--finetune_max_epochs", "1"]


@functools.cache
def _jax_cli(save_dir):
    stats = jcli.main(CLI_ARGS + ["--save", save_dir])
    return stats


@functools.cache
def _port_pipeline(save_dir):
    """The JAX CLI's dense random:tiny model carried across, quantized by the
    port's pipeline with the CLI's settings on the same ids, saved."""
    jcfg = jllama.ModelConfig.tiny()
    jp = jllama.init_random_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = params_from_numpy(to_numpy_tree(jp), device="cpu")
    ids = np.random.RandomState(0).randint(0, 256, size=(4, 16), dtype=np.int32)
    cfg = pipe.QuantizePipelineConfig(
        scheme=SCHEME_2X8, calib=eng.CalibConfig(max_epochs=2, steps_per_epoch=2, init_max_iter=5,
                                                 relative_mse_tolerance=None),
        finetune=bw.BlockFinetuneConfig(max_epochs=1), verbose=False)
    params, stats = pipe.quantize_model(params, llama.ModelConfig.tiny(), T(ids).long(), cfg)
    save_quantized_model(save_dir, params, llama.ModelConfig.tiny())
    return params, stats


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    return str(root / "jax"), str(root / "port")


def test_quantize_model_out_loss_near_jax(dirs):
    jstats = _jax_cli(dirs[0])
    _, stats = _port_pipeline(dirs[1])
    assert len(stats["out_loss"]) == len(jstats["out_loss"]) == 2
    for got, want in zip(stats["out_loss"], jstats["out_loss"]):
        assert abs(got - want) <= 0.1 * want, (stats["out_loss"], jstats["out_loss"])
    assert stats["avg_bits"] == pytest.approx(jstats["avg_bits"], rel=1e-12)
    # (k/v here have 256 groups for 256 centroids: the k-means init is exact,
    # so "below the init" is checked at 64x128 above and on the card)
    assert all(np.isfinite(p["final_mse"]) for p in stats["projections"])


def test_saved_checkpoint_is_byte_identical_in_jax(dirs):
    _jax_cli(dirs[0])  # its config.json is compared below
    params, _ = _port_pipeline(dirs[1])
    jp, jcfg = j_load(dirs[1])
    assert jcfg == jllama.ModelConfig.tiny()
    want = to_numpy_tree(jp)
    np.testing.assert_array_equal(params["embed"].numpy(), want["embed"])
    np.testing.assert_array_equal(params["lm_head"].weight.numpy(), want["lm_head"]["weight"])
    for layer, ref in zip(params["layers"], want["layers"]):
        for name in llama.QUANTIZABLE_PROJS:
            assert ref[name]["mode"] == "reference" and ref[name]["scheme"] == "2x8g8"
            for f in ("codes", "codebooks", "scales"):
                a, b = getattr(layer[name], f).detach().numpy(), ref[name][f]
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), (name, f)
        for name in ("input_norm", "post_attn_norm"):
            assert layer[name].detach().numpy().tobytes() == ref[name].tobytes()
    with open(os.path.join(dirs[1], "config.json")) as f:
        port_cfg = json.load(f)
    with open(os.path.join(dirs[0], "config.json")) as f:
        jax_cfg = json.load(f)
    for key in ("model_family", "model_config", "quantization_config"):
        assert port_cfg[key] == jax_cfg[key]
    # the port reads its own save back
    back, cfg = load_quantized_model(dirs[1], device="cpu")
    assert cfg == llama.ModelConfig.tiny()
    assert torch.equal(back["layers"][1]["down_proj"].codes, params["layers"][1]["down_proj"].codes)


def test_materialized_codes_checkpoint_reads_byte_identical_in_jax(dirs, tmp_path):
    """The save side's runtime layouts: the calibrated model transcoded to
    codes mode and saved by the port holds JAX's own transcode, byte for byte."""
    _port_pipeline(dirs[1])
    params, cfg = load_quantized_model(dirs[1], device="cpu")
    save_quantized_model(str(tmp_path), convert_runtime_mode(params, "codes"), cfg)
    with open(os.path.join(str(tmp_path), "config.json")) as f:
        assert json.load(f)["runtime_mode"] == "codes"
    got = to_numpy_tree(j_load(str(tmp_path))[0])
    want = to_numpy_tree(j_convert(j_load(dirs[1])[0], "codes"))
    for layer, ref in zip(got["layers"], want["layers"]):
        for name in llama.QUANTIZABLE_PROJS:
            assert layer[name]["mode"] == ref[name]["mode"] == "codes"
            for f in ("codes_tl", "codes_t", "codebooks", "scales"):
                a, b = layer[name][f], ref[name][f]
                a, b = (x["__bf16__"] if isinstance(x, dict) else x for x in (a, b))
                assert (a is None and b is None) or a.tobytes() == b.tobytes(), (name, f)


def test_calibrated_checkpoint_served_greedy_identical_to_jax(dirs):
    _port_pipeline(dirs[1])
    kw = dict(max_batch=2, max_len=64, prefill_buckets=(16, 32), kv_quantized=True)
    prompts = [np.arange(5, 25) % 256, np.arange(100, 112) % 256]
    jp, jcfg = j_load(dirs[1])
    jengine = JEngine(j_convert(jp, "codes"), jcfg, JServe(**kw))
    want = jengine.generate(prompts, JSampling(max_new_tokens=6))
    params, cfg = load_quantized_model(dirs[1], device="cpu")
    engine = Engine(convert_runtime_mode(params, "codes"), cfg, ServeConfig(**kw), device="cpu")
    got = engine.generate(prompts, SamplingParams(max_new_tokens=6))
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]
    assert all(len(g) == 6 for g in got)


def test_quantize_cli_on_cpu_matches_jax_avg_bits(dirs, tmp_path, capsys):
    jstats = _jax_cli(dirs[0])
    capsys.readouterr()
    stats = cli.main(CLI_ARGS + ["--device", "cpu", "--save", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["avg_bits"] == jstats["avg_bits"] == stats["avg_bits"]
    assert set(last["seconds"]) == {"init", "adam", "beam", "capture", "finetune", "propagate"}
    jp, jcfg = j_load(str(tmp_path))
    assert jcfg == jllama.ModelConfig.tiny() and len(jp["layers"]) == 2
    with open(os.path.join(str(tmp_path), "config.json")) as f:
        assert json.load(f)["cli_args"]["device"] == "cpu"


@pytest.mark.parametrize("flag,item", [(["--mesh_model", "2"], "A14"),
                                       (["--eval_datasets", "wikitext2"], "A11"),
                                       (["--wandb"], "A15")])
def test_quantize_cli_unported_options_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(CLI_ARGS + ["--device", "cpu"] + flag)


def test_calibration_taps_of_other_families_raise():
    from aqlm_tpu_torch.models import falcon, family, mixtral

    assert family.taps_fn(llama.ModelConfig.tiny()) is llama.block_forward_with_taps
    for mod, cfg in ((mixtral, mixtral.MixtralConfig.tiny()), (falcon, falcon.FalconConfig.tiny())):
        with pytest.raises(NotImplementedError, match="A12"):
            family.taps_fn(cfg)(None, {}, cfg, None)
