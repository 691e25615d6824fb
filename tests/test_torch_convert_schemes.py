"""The port's scheme converters (aqlm_tpu_torch.calib.requantize,
aqlm_tpu_torch.ops.transcode, ``cli.convert --to requant|2x8|2x7``) against
aqlm_tpu's on the CPU.

JAX draws its starting points with ``jax.random`` (the k-means init of
``calib.engine.init_quantized_weight``, the first centers of
``ops.transcode.fit_additive_split``) and the port with ``torch.Generator``s,
which give other numbers. So each test carries JAX's draw across: JAX's
init is recorded as it runs, and the port's drawing step is patched to
return it (``init_quantized_weight`` in ``calib.requantize``,
``_initial_centers`` in ``ops.transcode``), as tests/test_torch_calib.py
starts the port's k-means from JAX's init.

Stated tolerances: from the same start, codes identical to JAX's, codebooks,
scales and rel-MSE within 1e-5 relative (f32 sums in another order); a
target of two codebooks by its dequantized weight, within 1e-4 (the refit's
co-occurrence is singular there, the books defined up to its null space:
tests/test_torch_pv.py's tolerance for ``find_optimal_codebooks``); the
converted checkpoints read by ``aqlm_tpu``'s loader, their arrays and
``extra_config`` equal to JAX's convert output under the same tolerances,
its printed per-projection lines identical; unquantized leaves shared, not
copied; a 2x7 checkpoint served in codes mode (K1/K2's plain versions)
within 2e-3 of JAX's codes mode, and within the card's 3e-2 of max|logit|
of its reference mode (codes mode rounds the codebooks to bf16).

The test model is one layer of a tiny Llama whose q_proj is 1x16 g8 (the
transcode's input) and down_proj 2x8 g8, its other projections dense: a
transcode fits all 65536 codebook rows, so each projection costs seconds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32

from aqlm_tpu.calib import requantize as jrq
from aqlm_tpu.cli import convert as jcli
from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.io import load_quantized_model as j_load
from aqlm_tpu.io import save_quantized_model as j_save
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.ops.dequant import dequantize_weight as j_dequantize
from aqlm_tpu.ops.dequant import random_aqlm_weight as j_random_weight
from aqlm_tpu.ops.runtime import QuantizedLinear as JQuantizedLinear
from aqlm_tpu_torch.calib import requantize as rq
from aqlm_tpu_torch.cli import convert
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.io import load_quantized_model
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.ops import transcode as tc
from aqlm_tpu_torch.ops.dequant import AqlmWeight, dequantize_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

CFG = dict(num_layers=1, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4)
ITERS = ["--transcode_iters", "5"]  # one joint pass over the (hi, lo) pairs


def _rel_close(got, want, tol=1e-5):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (float(np.abs(got - want).max()), scale)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("schemes") / "source")
    jcfg = jllama.ModelConfig.tiny(**CFG)
    params = jllama.init_random_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    layer = params["layers"][0]
    for name, scheme, key in (("q_proj", "1x16g8", 1), ("down_proj", "2x8g8", 2)):
        out_f, in_f = layer[name].weight.shape
        w = j_random_weight(jax.random.PRNGKey(key), JScheme.parse(scheme), out_f, in_f)
        layer[name] = JQuantizedLinear.from_aqlm(w, mode="reference")
    j_save(path, params, jcfg)
    return path


def _jax_transcode_init(n_rows, n_centers, seed, device):
    """JAX's first centers (``fit_additive_split``'s draw) as the port's."""
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(jax.random.choice(k1, n_rows, (n_centers,), replace=False)))


class _InitRecorder:
    """Wraps JAX's ``init_quantized_weight`` in ``calib.requantize``: records
    each call's weight and result; ``port_init`` replays them, in order, as
    the port's init (checking that the port asks for the same weight)."""

    def __init__(self):
        self.calls = []

    def jax_init(self, W, scheme, **kw):
        out = jrq_init(W, scheme, **kw)
        self.calls.append((np.array(W), out))
        return out

    def port_init(self, W, scheme, **kw):
        want_w, out = self.calls.pop(0)
        np.testing.assert_allclose(W.numpy(), want_w, rtol=1e-6, atol=1e-7)
        return AqlmWeight(codes=torch.from_numpy(np.array(out.codes)),
                          codebooks=torch.from_numpy(np.array(out.codebooks)),
                          scales=torch.from_numpy(np.array(out.scales)), bias=None,
                          scheme=AqlmScheme.parse(out.scheme.name))


jrq_init = jrq.init_quantized_weight


@pytest.mark.parametrize("target", ["2x8g8"])  # 1x8: test_convert_requant_matches_jax
def test_requantize_weight_matches_jax(target, monkeypatch):
    jw = j_random_weight(jax.random.PRNGKey(3), JScheme.parse("1x16g8"), 128, 128)
    rec = _InitRecorder()
    monkeypatch.setattr(jrq, "init_quantized_weight", rec.jax_init)
    monkeypatch.setattr(rq, "init_quantized_weight", rec.port_init)
    want, want_rel = jrq.requantize_weight(jw, JScheme.parse(target), key=jax.random.PRNGKey(5),
                                           refine_iters=2)
    w = AqlmWeight(codes=torch.from_numpy(np.array(jw.codes)),
                   codebooks=torch.from_numpy(np.array(jw.codebooks)),
                   scales=torch.from_numpy(np.array(jw.scales)), bias=None,
                   scheme=AqlmScheme.parse("1x16g8"))
    got, rel = rq.requantize_weight(w, AqlmScheme.parse(target), refine_iters=2)
    assert got.scheme == AqlmScheme.parse(target) and got.codes.dtype == torch.uint8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    _rel_close(got.scales, want.scales)
    np.testing.assert_allclose(rel, want_rel, rtol=1e-5)
    if got.scheme.num_codebooks == 1:
        _rel_close(got.codebooks, want.codebooks)
    else:
        # the least-squares refit's co-occurrence is singular with two books
        # (a vector added to one and taken from the other changes nothing):
        # the books compare by what they dequantize to, within the 1e-4 of
        # find_optimal_codebooks' own test (JAX's SVD lstsq and torch's pinv
        # round the near-cut-off directions differently)
        _rel_close(dequantize_weight(got, dtype=torch.float32),
                   j_dequantize(want, dtype=jnp.float32), tol=1e-4)
    assert 0 < rel < 1


def test_requantize_params_shares_unquantized_leaves(ckpt):
    params, _ = load_quantized_model(ckpt, device="cpu")
    draft, worst = rq.requantize_params(params, AqlmScheme.parse("1x8g8"), refine_iters=1,
                                        kmeans_iter=10)
    assert 0 < worst < 1
    assert draft["embed"] is params["embed"] and draft["lm_head"] is params["lm_head"]
    layer, src = draft["layers"][0], params["layers"][0]
    assert layer["input_norm"] is src["input_norm"] and layer["k_proj"] is src["k_proj"]
    for name in ("q_proj", "down_proj"):
        q = layer[name]
        assert isinstance(q, QuantizedLinear) and q.mode == "reference"
        assert q.scheme.num_codebooks == 1 and q.scheme.nbits_per_codebook == 8
    with pytest.raises(ValueError, match="S<=1024"):
        rq.requantize_weight(AqlmWeight(codes=None, codebooks=None, scales=None, bias=None,
                                        scheme=src["down_proj"].scheme),
                             AqlmScheme.parse("1x16g8"))


def _arrays(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as data:
                out.update({f"{name}/{k}": data[k] for k in data.files})
    return out


def _same_checkpoint(got_dir, want_dir):
    got, want = _arrays(got_dir), _arrays(want_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.endswith("__meta__"):
            assert json.loads(str(got[k])) == json.loads(str(want[k])), k
        elif want[k].dtype.kind in "iu" or k.endswith(".codes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k.endswith((".codebooks", ".scales")):
            _rel_close(got[k], want[k])
        else:
            assert got[k].tobytes() == want[k].tobytes(), k
    with open(os.path.join(got_dir, "config.json")) as f, \
            open(os.path.join(want_dir, "config.json")) as g:
        got_cfg, want_cfg = json.load(f), json.load(g)
    extra = lambda c: {k: v for k, v in c.items() if k in ("requantized_to", "transcoded_from")}
    assert extra(got_cfg) == extra(want_cfg) and extra(want_cfg)
    np.testing.assert_allclose(got_cfg["worst_rel_mse"], want_cfg["worst_rel_mse"], rtol=1e-5)
    strip = lambda c: {k: v for k, v in c.items() if k != "worst_rel_mse"}
    assert strip(got_cfg) == strip(want_cfg)
    jp, _ = j_load(got_dir)  # aqlm_tpu reads the port's output
    return jp


def _lines(text, marker):
    return [line for line in text.splitlines() if marker in line]


def test_convert_requant_matches_jax(ckpt, tmp_path, monkeypatch, capsys):
    rec = _InitRecorder()
    monkeypatch.setattr(jrq, "init_quantized_weight", rec.jax_init)
    monkeypatch.setattr(rq, "init_quantized_weight", rec.port_init)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--to", "requant", "--scheme", "1x8", "--refine_iters", "2"]
    jcli.main([ckpt, jdir, *args])
    jout = capsys.readouterr().out
    assert len(rec.calls) == 2  # q_proj and down_proj
    convert.main([ckpt, pdir, *args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert not rec.calls
    assert _lines(out, "rel-MSE") == _lines(jout, "rel-MSE") and len(_lines(out, "rel-MSE")) == 3
    jp = _same_checkpoint(pdir, jdir)
    assert jp["layers"][0]["q_proj"].scheme.name == JScheme.parse("1x8g8").name


@pytest.fixture(scope="module")
def transcoded(ckpt, tmp_path_factory):
    """JAX's ``convert --to 2x8`` and ``--to 2x7`` of the checkpoint."""
    root = tmp_path_factory.mktemp("transcoded")
    out = {}
    for to in ("2x8", "2x7"):
        out[to] = str(root / f"jax_{to}")
        jcli.main([ckpt, out[to], "--to", to, *ITERS])
    return out


@pytest.mark.parametrize("to", ["2x8", "2x7"])
def test_convert_transcode_matches_jax(ckpt, transcoded, tmp_path, monkeypatch, capsys, to):
    monkeypatch.setattr(tc, "_initial_centers", _jax_transcode_init)
    capsys.readouterr()
    pdir = str(tmp_path / "port")
    convert.main([ckpt, pdir, "--to", to, *ITERS, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("codebook rel-MSE") == 2  # q_proj's line and the worst
    jp = _same_checkpoint(pdir, transcoded[to])
    q = jp["layers"][0]["q_proj"]
    assert q.scheme.num_codebooks == 2 and q.scheme.nbits_per_codebook == int(to[-1])
    assert q.codebooks.shape == (2, 2 ** int(to[-1]), 1, 8)


def test_transcode_refuses_other_schemes():
    w = AqlmWeight(codes=torch.zeros((4, 2, 2), dtype=torch.uint8),
                   codebooks=torch.zeros((2, 256, 1, 8)), scales=torch.ones(4), bias=None,
                   scheme=AqlmScheme.parse("2x8g8"))
    with pytest.raises(ValueError, match="1x16"):
        tc.transcode_1x16_to_2x8(w)
    w16 = AqlmWeight(codes=torch.zeros((4, 2, 1), dtype=torch.int16),
                     codebooks=torch.zeros((1, 65536, 1, 8)), scales=torch.ones(4), bias=None,
                     scheme=AqlmScheme.parse("1x16g8"))
    with pytest.raises(ValueError, match="nbits"):
        tc.transcode_1x16_to_2xN(w16, nbits=9)


def test_transcoded_2x7_serves_in_codes_mode(transcoded):
    """The 2x7 checkpoint (128-row codebooks) in codes mode: q_proj's codes
    tiled for K1/K2 (OUT 128), their plain versions here, against JAX's codes
    mode on the same ids."""
    from aqlm_tpu_torch.cli.common import resolve_model
    from aqlm_tpu.cli.common import resolve_model as j_resolve

    params, cfg, _ = resolve_model(transcoded["2x7"], mode="codes", device="cpu")
    jparams, jcfg, _ = j_resolve(transcoded["2x7"], mode="codes")
    q = params["layers"][0]["q_proj"]
    assert q.mode == "codes" and q.codes_tl is not None and q.codebooks.shape[1] == 128
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    got, _ = llama.forward(params, cfg, torch.from_numpy(ids))
    want, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids))
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32), rtol=2e-3, atol=2e-3)
    # against reference mode: codes mode holds the codebooks in bf16, so the
    # card's gate on it (chip_smoke.py: 3e-2 of max|logit|)
    ref, _ = llama.forward(resolve_model(transcoded["2x7"], mode="reference", device="cpu")[0],
                           cfg, torch.from_numpy(ids))
    assert float((got - ref).abs().max()) <= 3e-2 * float(ref.abs().max())
