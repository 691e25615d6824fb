"""The port's scanned PV student (aqlm_tpu_torch.pv.straight_through:
``scanned_student_hidden``, ``_make_manual_st_proj``, the remat glue) and
``cli.finetune --scan_blocks`` against aqlm_tpu's on the CPU, the same numpy
inputs through both, f32.

Stated tolerances, and why:

- the remat glue (attention at 1 and 2 query heads a kv head with a fully
  masked query row; SiLU-times-up): f32 outputs and gradients rtol 1e-5 /
  atol 1e-6 (the same formulas, sums in another order); bf16 within one bf16
  step (2^-7 relative, 1e-3 of the largest);
- the manual projection at dequant_impl "xla" and "kernel" (the kernel's
  plain versions: codebook entries rounded to bf16, as JAX's kernel rounds
  them), window 1 and 2, the layer inside and outside the window, with and
  without a bias: y, dx, the codebook, scale, bias and window gradients rtol
  1e-5 / atol 1e-6;
- ``scanned_student_hidden`` through ``make_pv_step``'s ``grad_fn`` at a
  3-layer tiny Llama, every remat mode and both dequant impls of "manual",
  at segments of 2 and 8 layers, the per-layer list and the windowed stack:
  loss rtol 1e-5, every gradient rtol 1e-4 / atol 1e-5 of JAX's (JAX's own
  scanned-vs-unrolled tolerances; JAX's "manual" at the matching dequant,
  whose remat modes and window forms JAX's own tests hold equal); the same
  against the port's unrolled path, a window of 1 and 2 layers; the
  windowed stack against the list form rtol 1e-6 (loss) and 1e-4 / 1e-6
  (gradients), JAX's; JAX's error messages;
- ``cli.finetune --scan_blocks`` and ``--scan_blocks --st_window 1
  --offload_teacher`` (2 steps, a V step after each): per-step KL within
  rtol 1e-4 of JAX's CLI on the
  same arguments (JAX's without ``--offload_teacher``, which casts its
  teacher to bf16 where the port's streams it in its own dtype), saved
  codes identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, pairs_by_path, to_numpy_tree

from aqlm_tpu.cli import finetune as jcli
from aqlm_tpu.config import SCHEME_2X8 as J2X8
from aqlm_tpu.io import save_quantized_model as j_save
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize
from aqlm_tpu.ops.dequant import random_aqlm_weight as j_random_weight
from aqlm_tpu.pv import configurable_adamw as j_adamw
from aqlm_tpu.pv import straight_through as jst
from aqlm_tpu_torch.cli import finetune as cli
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.io.checkpoint import _loadz
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.pv import configurable_adamw
from aqlm_tpu_torch.pv import straight_through as st
from aqlm_tpu_torch.pv.trainer import tree_leaves

T = torch.from_numpy
TINY = dict(num_layers=3, hidden_size=64, intermediate_size=128)
SCHEME_2X8 = AqlmScheme.parse("2x8g8")


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32), rtol=rtol, atol=atol)


# --- the remat glue ---------------------------------------------------------------


def _bf16_close(got, want):
    g, w = f32(got), np.asarray(want, np.float32)
    assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-3 * np.abs(w).max())


def _np_in(dtype, *shapes, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bf16":  # values on the bf16 grid, the same in both frameworks
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in arrs]
    return arrs


def _as(dtype, arr):
    return (jnp.asarray(arr, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
            T(arr).to(torch.bfloat16 if dtype == "bf16" else torch.float32))


@pytest.mark.parametrize("rep,dtype", [(1, "f32"), (2, "f32"), (2, "bf16")])
def test_attention_remat_matches_jax(rep, dtype):
    b, t, hkv, d = 2, 6, 2, 8
    q, k, v, g = _np_in(dtype, (b, t, hkv * rep, d), (b, t, hkv, d), (b, t, hkv, d),
                        (b, t, hkv * rep, d))
    mask = np.tril(np.ones((t, t), bool))[None, None].repeat(b, 0)
    mask[1, 0, 3, :] = False  # a query row that sees no key
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_as(dtype, a) for a in (q, k, v, g))
    jout, vjp = jax.vjp(lambda *a: jst._attention_remat(*a, jnp.asarray(mask)), jq, jk, jv)
    jgrads = vjp(jg)
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    out = st._attention_remat(*leaves, T(mask))
    grads = torch.autograd.grad(out, leaves, tg)
    for got, want in zip((out,) + grads, (jout,) + jgrads):
        if dtype == "bf16":
            _bf16_close(got, want)
        else:
            _close(got, want, 1e-5, 1e-6)
    # the forward is models.common.attention's, and so is autograd's gradient of it
    plain = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    from aqlm_tpu_torch.models.common import attention

    ref = attention(*plain, T(mask))
    assert torch.equal(out, ref)
    if dtype == "f32":
        for got, want in zip(grads, torch.autograd.grad(ref, plain, tg)):
            _close(got, want.numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_mul_remat_matches_jax(dtype):
    gate, up, g = _np_in(dtype, (3, 5, 16), (3, 5, 16), (3, 5, 16), seed=1)
    (jgate, tgate), (jup, tup), (jg, tg) = (_as(dtype, a) for a in (gate, up, g))
    jout, vjp = jax.vjp(jst._silu_mul_remat, jgate, jup)
    jgrads = vjp(jg)
    leaves = [tgate.clone().requires_grad_(True), tup.clone().requires_grad_(True)]
    out = st._silu_mul_remat(*leaves)
    grads = torch.autograd.grad(out, leaves, tg)
    for got, want in zip((out,) + grads, (jout,) + jgrads):
        if dtype == "bf16":
            _bf16_close(got, want)
        else:
            _close(got, want, 1e-5, 1e-6)


# --- the manual straight-through projection ------------------------------------------

PROJ_CASES = [(impl, win, li, bias) for impl in ("xla", "kernel") for win, li in
              ((1, 2), (1, 0), (2, 3), (2, 1)) for bias in (False, True)]


@pytest.mark.parametrize("impl,win,li,bias", PROJ_CASES,
                         ids=[f"{i}-win{w}-layer{l}-{'bias' if b else 'nobias'}"
                              for i, w, l, b in PROJ_CASES])
def test_manual_st_proj_matches_jax(impl, win, li, bias):
    out_f, in_f, start = 16, 32, 2  # the window is layers [2, 2 + win)
    jw = j_random_weight(jax.random.PRNGKey(li + 10 * win), J2X8, out_f, in_f, with_bias=bias)
    rng = np.random.default_rng(li)
    x, g = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, in_f), (2, 5, out_f)))
    st_arr = rng.standard_normal((win, out_f, in_f)).astype(np.float32)
    codes, cbs, scales = (np.array(a) for a in (jw.codes, jw.codebooks, jw.scales))
    b = None if jw.bias is None else np.array(jw.bias)

    jf = jst._make_manual_st_proj(J2X8, jnp.float32, True, win, bias, dequant_impl=impl)
    jcodes, jli, jstart = jnp.asarray(codes), jnp.int32(li), jnp.int32(start)
    if bias:
        jfun = lambda x_, c_, s_, b_, st_: jf(x_, jcodes, c_, s_, b_, st_, jli, jstart)
        primals = (x, cbs, scales, b, st_arr)
    else:
        jfun = lambda x_, c_, s_, st_: jf(x_, jcodes, c_, s_, None, st_, jli, jstart)
        primals = (x, cbs, scales, st_arr)
    jy, vjp = jax.vjp(jfun, *(jnp.asarray(a) for a in primals))
    jgrads = vjp(jnp.asarray(g))

    f = st._make_manual_st_proj(SCHEME_2X8, torch.float32, True, win, bias, dequant_impl=impl)
    leaves = [T(a).clone().requires_grad_(True) for a in primals]
    y = f(leaves[0], T(codes), leaves[1], leaves[2], leaves[3] if bias else None, leaves[-1],
          li, start)
    grads = torch.autograd.grad(y, leaves, T(g), allow_unused=True)
    _close(y, jy, 1e-5, 1e-6)
    inside = start <= li < start + win
    for got, want in zip(grads, jgrads):
        if got is None:  # the window, from a layer outside it: JAX's gradient is zeros
            assert not inside and not np.asarray(want).any()
            continue
        _close(got, want, 1e-5, 1e-6)
    assert (grads[-1] is not None) == inside


def test_manual_st_proj_kernel_refuses_group_scales():
    f = st._make_manual_st_proj(SCHEME_2X8, torch.float32, False, 0, False, "kernel")
    w = j_random_weight(jax.random.PRNGKey(0), J2X8, 16, 32)
    codes, cbs = T(np.array(w.codes)), T(np.array(w.codebooks))
    with pytest.raises(ValueError, match="per-group scales"):
        f(torch.zeros(1, 32), codes, cbs, torch.ones(16, 4), None, None, 0, 0)
    with pytest.raises(ValueError, match="dequant_impl"):
        st._make_manual_st_proj(SCHEME_2X8, torch.float32, False, 0, False, "pallas")


# --- scanned_student_hidden through make_pv_step's grad_fn ---------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jllama.ModelConfig.tiny(**TINY), llama.ModelConfig.tiny(**TINY)
    jt = jllama.init_random_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    js = j_random_quantize(jax.random.PRNGKey(1),
                           jllama.init_random_params(jax.random.PRNGKey(8), jcfg,
                                                     dtype=jnp.float32), J2X8)
    port = lambda p: params_from_numpy(to_numpy_tree(p), device="cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, cfg, js, port(js), jt, port(jt), ids


# JAX's gradients, one jit compile each: "manual" at its two dequant impls,
# the window at layer 1. JAX's other remat modes and its windowed stack
# compute the same values (its own tests hold them to the tolerances used
# here), so the port's "dequant", "block" and "none" and its windowed stack
# are held against JAX's "manual" with the "xla" dequant.
JAX_VARIANTS = [("manual", "xla"), ("manual", "kernel")]


def _window(st_buffers, active):
    return {name: torch.stack([st_buffers[li][name] for li in active])
            for name in st_buffers[active[0]]}


@pytest.fixture(scope="module")
def jax_grads(models):
    jcfg, _, js, _, jt, _, ids = models
    out = {}
    for remat, impl in JAX_VARIANTS:
        jpv = jst.PVConfig(chunk_tokens=8, scan_blocks=True, scan_remat=remat, scan_dequant=impl)
        jstate = jst.init_pv_state(js, j_adamw(1e-3), j_adamw(1e-3), active_layers=(1,))
        loss, grads = jax.jit(jst.make_pv_step(jcfg, jcfg, jpv).grad_fn)(
            jstate, jt, jnp.asarray(ids))
        out[impl] = (float(loss), grads)
    return out


def _port_grad(models, remat, impl, active, segment, form, scan=True):
    _, cfg, _, s, _, t, ids = models
    pv = st.PVConfig(chunk_tokens=8, scan_blocks=scan, scan_remat=remat, scan_dequant=impl,
                     scan_segment_layers=segment)
    state = st.init_pv_state(s, configurable_adamw(1e-3), configurable_adamw(1e-3),
                             active_layers=active)
    args = ()
    if form == "window":
        state.st_buffers = _window(state.st_buffers, active)
        args = (None, active[0])
    return st.make_pv_step(cfg, cfg, pv).grad_fn(state, t, T(ids).long(), *args)


SCAN_CASES = [(remat, impl, segment, form)
              for remat, impl in (("manual", "xla"), ("manual", "kernel"), ("dequant", "auto"),
                                  ("block", "auto"), ("none", "auto"))
              for segment in (2, 8) for form in ("list", "window")]


@pytest.mark.parametrize("remat,impl,segment,form", SCAN_CASES,
                         ids=[f"{r}-{i}-seg{s}-{f}" for r, i, s, f in SCAN_CASES])
def test_scanned_grad_fn_matches_jax(models, jax_grads, remat, impl, segment, form):
    jloss, (jg_tr, jg_st) = jax_grads["kernel" if impl == "kernel" else "xla"]
    loss, (g_tr, g_st) = _port_grad(models, remat, impl, (1,), segment, form)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    if form == "window":  # JAX's list-form window gradients as the same stack
        jg_st = {name: jnp.stack([jg_st[1][name]]) for name in g_st}
    pairs = pairs_by_path(jg_tr, g_tr) + pairs_by_path(jg_st, g_st)
    assert len(pairs) == len([x for x in jax.tree.leaves((jg_tr, jg_st)) if x is not None])
    for got, want in pairs:
        _close(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("remat,active", [("manual", (1,)), ("dequant", (1,)),
                                          ("manual", (1, 2))])
def test_scanned_equals_unrolled_and_window_equals_list(models, remat, active):
    unrolled = _port_grad(models, "manual", "auto", active, 8, "list", scan=False)
    listed = _port_grad(models, remat, "auto", active, 8, "list")
    windowed = _port_grad(models, remat, "auto", active, 2, "window")
    np.testing.assert_allclose(float(listed[0]), float(unrolled[0]), rtol=1e-5)
    np.testing.assert_allclose(float(windowed[0]), float(listed[0]), rtol=1e-6)
    for a, b in zip(tree_leaves(unrolled[1]), tree_leaves(listed[1])):
        _close(b, a.numpy(), 1e-4, 1e-5)
    w_tr, w_st = windowed[1]
    for a, b in zip(tree_leaves(listed[1][0]), tree_leaves(w_tr)):
        _close(b, a.numpy(), 1e-4, 1e-6)
    for name, stack in w_st.items():
        for slot, li in enumerate(active):
            _close(stack[slot], listed[1][1][li][name].numpy(), 1e-4, 1e-6)


def test_scan_blocks_errors_match_jax(models):
    jcfg, cfg, js, s, _, _, ids = models
    ids_t = T(ids).long()
    with pytest.raises(AssertionError, match="scan_blocks requires the chunked loss"):
        jst.make_pv_step(jcfg, jcfg, jst.PVConfig(chunk_tokens=0, scan_blocks=True))
    with pytest.raises(ValueError, match="scan_blocks requires the chunked loss"):
        st.make_pv_step(cfg, cfg, st.PVConfig(chunk_tokens=0, scan_blocks=True))
    state = st.init_pv_state(s, configurable_adamw(1e-3), None, active_layers=(0, 2))
    with pytest.raises(ValueError, match=r"contiguous active window, got \[0, 2\]"):
        st.scanned_student_hidden(s, state.st_buffers, cfg, ids_t)
    window = _window(state.st_buffers, (0,))
    with pytest.raises(ValueError, match="windowed st_buffers need window_start"):
        st.scanned_student_hidden(s, window, cfg, ids_t)
    dense = dict(s, layers=[dict(layer) for layer in s["layers"]])
    dense["layers"][1]["o_proj"] = DenseLinear(weight=torch.zeros(64, 64), bias=None)
    with pytest.raises(ValueError, match="homogeneous reference-mode layers; 'o_proj'"):
        st.scanned_student_hidden(dense, [{}] * 3, cfg, ids_t)
    with pytest.raises(ValueError, match="remat"):
        st.scanned_student_hidden(s, [{}] * 3, cfg, ids_t, remat="full")
    with pytest.raises(AssertionError, match="contiguous active window"):
        jstate = jst.init_pv_state(js, j_adamw(1e-3), j_adamw(1e-3), active_layers=(0, 2))
        jst.scanned_student_hidden(js, jstate.st_buffers, jcfg, jnp.asarray(ids))


# --- cli.finetune --scan_blocks against JAX's CLI ---------------------------------------

RUN = ["--dataset", "random", "--nsamples", "8", "--model_seqlen", "16", "--batch_size", "4",
       "--microbatch_size", "2", "--total_steps", "2", "--code_update_every", "1",
       "--code_lr", "5e-2", "--max_code_change_per_step", "0.25", "--loss_tokens_per_chunk", "8",
       "--seed", "3", "--scan_blocks"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_scan")
    cfg = jllama.ModelConfig.tiny(num_layers=2, hidden_size=64, intermediate_size=128)
    teacher = jllama.init_random_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    student = j_random_quantize(jax.random.PRNGKey(1), jax.tree.map(lambda x: x, teacher), J2X8)
    paths = {"teacher": str(root / "teacher"), "student": str(root / "student"), "root": root}
    j_save(paths["teacher"], teacher, cfg)
    j_save(paths["student"], student, cfg)
    return paths


def _codes(path):
    out = {}
    for li in range(2):
        arrays = _loadz(os.path.join(path, f"layer_{li}.npz"))
        out.update({f"{li}.{k}": v.numpy() for k, v in arrays.items() if k.endswith(".codes")})
    return out


@pytest.mark.parametrize("extra", [[], ["--st_window", "1", "--offload_teacher"]],
                         ids=["scan", "scan-st_window-offload"])
def test_cli_scan_blocks_matches_jax(dirs, tmp_path, monkeypatch, extra):
    argv = lambda out: ["--base_model", dirs["teacher"], "--quantized_model", dirs["student"],
                        *RUN, "--save", str(out), *extra]
    res = cli.main(argv(tmp_path / "port") + ["--device", "cpu"])
    resolve = jcli.resolve_model

    def as_dense(spec, **kw):  # JAX's CLI takes only random: or HF teachers as dense
        params, cfg, kind = resolve(spec, **kw)
        return params, cfg, "dense" if spec == dirs["teacher"] else kind

    monkeypatch.setattr(jcli, "resolve_model", as_dense)
    # JAX's --offload_teacher casts the teacher to bf16 (the port streams it in
    # its own dtype, so its offload run is its plain run): JAX runs without it
    jres = jcli.main([a for a in argv(tmp_path / "jax") if a != "--offload_teacher"])
    assert len(res["step_losses"]) == 2 and all(np.isfinite(res["step_losses"]))
    np.testing.assert_allclose(res["step_losses"], jres["losses"], rtol=1e-4)
    got, want = _codes(str(tmp_path / "port")), _codes(str(tmp_path / "jax"))
    assert got.keys() == want.keys() and len(got) == 14
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    start = _codes(dirs["student"])
    assert sum(int((got[k] != start[k]).any(-1).sum()) for k in got) > 0  # V steps moved codes


def test_cli_scan_blocks_refuses_other_families(tmp_path):
    from aqlm_tpu_torch.io import save_quantized_model
    from aqlm_tpu_torch.models import falcon
    from aqlm_tpu_torch.models.quantize import random_quantized_params

    cfg = falcon.FalconConfig.tiny(num_layers=1)
    gen = torch.Generator().manual_seed(0)
    save_quantized_model(str(tmp_path / "t"), falcon.init_random_params(
        gen, cfg, dtype=torch.float32, device="cpu"), cfg)
    save_quantized_model(str(tmp_path / "s"), random_quantized_params(
        gen, cfg, SCHEME_2X8, mode="reference", dtype=torch.float32, device="cpu"), cfg)
    with pytest.raises(ValueError, match="scan_blocks supports llama-family students only"):
        cli.main(["--base_model", str(tmp_path / "t"), "--quantized_model", str(tmp_path / "s"),
                  *RUN, "--device", "cpu"])
