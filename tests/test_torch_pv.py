"""The port's PV-tuning modules (aqlm_tpu_torch.pv, calib.beam_search_l2)
against aqlm_tpu's on the CPU, the same numpy inputs through both, f32.

Stated tolerances, and why:

- the KL losses (whole and chunked at 8/16/64/100 tokens a chunk over 40
  tokens, a mask, a tied head with softcap and logit scale): values rtol
  1e-5, gradients rtol 1e-4 / atol 1e-7 (sums in another order);
- ``ConfigurableAdamW`` against ``configurable_adamw``, 5 steps of every case
  of tests/test_configurable_adam.py and bf16 moments: params rtol 1e-5
  (f32 arithmetic, the debiasing factors in double here and f32 there);
  the bf16 moments in bf16, within one bf16 step;
- the L2 beam search without randomness (beam 1, 2 and 4, a max update
  fraction, a trust ratio, force_update, per-group scales): codes
  identical; with stochastic rounding or a selection temperature the two
  draw other numbers, so only properties are checked; the codebook-blocked
  scoring equals the one-pass scoring; ``find_optimal_codebooks``: the
  refit groups within 1e-4 of JAX's (the codebooks themselves are defined
  up to the co-occurrence's null space);
- ``make_distill_step``, one step, and ``make_pv_step``'s ``grad_fn`` at a
  tiny Llama, Falcon and Mixtral: loss rtol 1e-5, every trainable and ST
  gradient within 1e-4 of its largest JAX magnitude; after an update the
  params within rtol 1e-5 and atol 2% of the lr: Adam's first update is
  lr * g / (|g| + eps), so where |g| is near eps the gradients' last bits
  move it by a part of lr; ``apply_fn`` then ``code_step``: codes
  identical; two microbatches with scale 1/2 equal one batch within the
  gradient tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, pairs_by_path, to_numpy_tree

from aqlm_tpu.calib import beam_search_l2 as jbl2
from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.models import falcon as jfalcon
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models import mixtral as jmixtral
from aqlm_tpu.models.quantize import random_quantize_projections as j_random_quantize
from aqlm_tpu.ops.dequant import dequantize_weight as j_dequantize
from aqlm_tpu.ops.dequant import random_aqlm_weight as j_random_weight
from aqlm_tpu.pv import configurable_adamw as j_adamw
from aqlm_tpu.pv import losses as jlosses
from aqlm_tpu.pv import straight_through as jst
from aqlm_tpu.pv import trainer as jtrainer
from aqlm_tpu_torch.calib import beam_search_l2 as bl2
from aqlm_tpu_torch.calib import beam_search_xtx
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import falcon, llama, mixtral
from aqlm_tpu_torch.pv import losses
from aqlm_tpu_torch.pv import straight_through as st
from aqlm_tpu_torch.pv import trainer
from aqlm_tpu_torch.pv.configurable_adam import ConfigurableAdamW, configurable_adamw
from aqlm_tpu_torch.pv.trainer import tree_leaves

T = torch.from_numpy
SCHEME_2X8 = JScheme.parse("2x8g8")


def _grad_close(got, want, tol=1e-4):
    got, want = f32(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (float(np.abs(got - want).max()), scale)


# --- losses -----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_kl_divergence_loss_and_grad(masked):
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((2, 7, 33)).astype(np.float32) * 2 for _ in range(2))
    m = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    jm = None if m is None else jnp.asarray(m)
    want, jg = jax.value_and_grad(jlosses.kl_divergence_loss)(jnp.asarray(s), jnp.asarray(t), jm)
    st_ = T(s).requires_grad_(True)
    got = losses.kl_divergence_loss(st_, T(t), None if m is None else T(m))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(f32(st_.grad), np.asarray(jg), rtol=1e-4, atol=1e-7)


CHUNK_CASES = [(8, "head"), (16, "head"), (64, "head"), (100, "head"), (16, "tied")]


@pytest.mark.parametrize("chunk,head", CHUNK_CASES, ids=[f"{c}-{h}" for c, h in CHUNK_CASES])
def test_chunked_kl_loss_matches_jax(chunk, head):
    rng = np.random.default_rng(1)
    b, t, h, v = 2, 40, 16, 48
    sh, th = (rng.standard_normal((b, t, h)).astype(np.float32) for _ in range(2))
    w_s, w_t = (rng.standard_normal((v, h)).astype(np.float32) * 0.3 for _ in range(2))
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    kw = dict(softcap=3.0, logit_scale=0.5) if head == "tied" else {}

    def jloss(s_hidden, s_w):
        heads = dict(student_embed=s_w, teacher_embed=jnp.asarray(w_t)) if head == "tied" else {}
        return jlosses.chunked_kl_loss(
            s_hidden, jnp.asarray(th), None if heads else s_w, None if heads else jnp.asarray(w_t),
            mask=jnp.asarray(mask), chunk_tokens=chunk, **heads, **kw)

    want, (jg_h, jg_w) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(sh),
                                                                   jnp.asarray(w_s))
    s_hidden, s_w = T(sh).requires_grad_(True), T(w_s).requires_grad_(True)
    heads = dict(student_embed=s_w, teacher_embed=T(w_t)) if head == "tied" else {}
    got = losses.chunked_kl_loss(s_hidden, T(th), None if heads else s_w,
                                 None if heads else T(w_t), mask=T(mask), chunk_tokens=chunk,
                                 **heads, **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(f32(s_hidden.grad), np.asarray(jg_h), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(f32(s_w.grad), np.asarray(jg_w), rtol=1e-4, atol=1e-7)
    # equal to the whole-logit loss
    full = losses.kl_divergence_loss(
        losses._project(T(sh), None if heads else T(w_s), T(w_s) if heads else None,
                        kw.get("softcap"), kw.get("logit_scale")),
        losses._project(T(th), None if heads else T(w_t), T(w_t) if heads else None,
                        kw.get("softcap"), kw.get("logit_scale")), T(mask))
    np.testing.assert_allclose(float(got), float(full), rtol=1e-5)


# --- ConfigurableAdamW --------------------------------------------------------

ADAM_CASES = [dict(), dict(amsgrad=True), dict(lamb=True),
              dict(lamb=True, weight_decay=0.01, clamp_value=5.0), dict(weight_decay=0.01),
              dict(b1=0.0, b2=0.95, amsgrad=True),
              dict(exp_avg_dtype="bf16", exp_avg_sq_dtype="bf16")]


@pytest.mark.parametrize("kwargs", ADAM_CASES,
                         ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()) or "adam")
def test_configurable_adamw_matches_jax(kwargs):
    kw = dict(kwargs)
    b1, b2 = kw.pop("b1", 0.9), kw.pop("b2", 0.999)
    jkw, tkw = dict(kw), dict(kw)
    for name in ("exp_avg_dtype", "exp_avg_sq_dtype"):
        if name in kw:
            jkw[name], tkw[name] = jnp.bfloat16, torch.bfloat16
    p0 = np.random.default_rng(2).standard_normal((6, 5)).astype(np.float32)
    jopt = j_adamw(1e-2, b1=b1, b2=b2, **jkw)
    jp = jnp.asarray(p0)
    jstate = jopt.init(jp)
    p = T(p0.copy())
    opt = configurable_adamw(1e-2, b1=b1, b2=b2, **tkw)([p])
    rng = np.random.RandomState(0)
    for _ in range(5):
        g = rng.randn(6, 5).astype(np.float32)
        upd, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = jp + upd
        p.grad = T(g)
        opt.step()
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    state = opt.state_of(p)
    assert state.step == 5
    if "exp_avg_dtype" in kw:
        assert state.exp_avg.dtype == state.exp_avg_sq.dtype == torch.bfloat16
        for mine, theirs in ((state.exp_avg, jstate.exp_avg),
                             (state.exp_avg_sq, jstate.exp_avg_sq)):
            want = np.asarray(theirs, np.float32)
            assert np.all(np.abs(f32(mine) - want) <= 2 ** -7 * np.abs(want) + 1e-12)


# --- the L2 beam search --------------------------------------------------------


def _l2_inputs(scheme, out_f, in_f, seed, per_group_scales=False, on_grid=False):
    """(target, codebooks, codes, scales); ``on_grid``: the target is the
    weight itself, so only force_update moves a code."""
    w = j_random_weight(jax.random.PRNGKey(seed), scheme, out_f, in_f)
    target = (np.asarray(j_dequantize(w)) if on_grid else
              np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 100), (out_f, in_f))))
    scales = np.asarray(w.scales)
    if per_group_scales:
        og, ig = out_f // scheme.out_group_size, in_f // scheme.in_group_size
        scales = (np.random.default_rng(seed).random((og, ig)) + 0.5).astype(np.float32)
    return (target.astype(np.float32), np.asarray(w.codebooks), np.asarray(w.codes), scales)


L2_CASES = {
    "beam1": (JScheme(2, 4, in_group_size=4), dict()),
    "beam2": (JScheme(2, 4, in_group_size=4), dict(beam_size=2)),
    "beam4_2x8": (JScheme(2, 8, in_group_size=8), dict(beam_size=4)),
    "fraction": (JScheme(2, 4, in_group_size=4), dict(max_update_fraction=0.25)),
    "trust": (JScheme(1, 4, in_group_size=4), dict(trust_ratio=0.05)),
    "trust_fraction": (JScheme(2, 4, in_group_size=4),
                       dict(trust_ratio=0.2, max_update_fraction=0.5)),
    "force": (JScheme(1, 4, in_group_size=4), dict(force_update=True, beam_size=2)),
    "out_groups": (JScheme(2, 4, in_group_size=2, out_group_size=2), dict(beam_size=2)),
    "group_scales": (JScheme(2, 4, in_group_size=4), dict(max_update_fraction=0.5)),
}


@pytest.mark.parametrize("case", list(L2_CASES))
def test_beam_search_l2_codes_identical(case):
    scheme, kw = L2_CASES[case]
    target, cb, codes, scales = _l2_inputs(scheme, 16, 32, 3, on_grid=case == "force",
                                           per_group_scales=case == "group_scales")
    want = jbl2.beam_search_optimal_codes_l2(jnp.asarray(target), jnp.asarray(cb),
                                             jnp.asarray(codes), jnp.asarray(scales), **kw)
    got = bl2.beam_search_optimal_codes_l2(T(target), T(cb), T(codes), T(scales), **kw)
    assert got.dtype == T(codes).dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    if kw.get("force_update"):
        assert np.all(np.any(got.numpy() != codes, axis=-1))
    if "max_update_fraction" in kw:
        changed = np.any(got.numpy() != codes, axis=-1).sum()
        assert changed <= int(np.ceil(kw["max_update_fraction"] * codes.shape[0] * codes.shape[1]))


def test_beam_search_l2_blocked_scoring_matches_one_pass(monkeypatch):
    target, cb, codes, scales = _l2_inputs(JScheme(2, 8, in_group_size=8), 32, 32, 4)
    args = (T(target), T(cb), T(codes), T(scales))
    for beam in (1, 2):
        plain = bl2.beam_search_optimal_codes_l2(*args, beam_size=beam)
        monkeypatch.setattr(beam_search_xtx, "_SCORE_S_BLOCK", 48)
        blocked = bl2.beam_search_optimal_codes_l2(*args, beam_size=beam)
        monkeypatch.undo()
        assert torch.equal(plain, blocked)


@pytest.mark.parametrize("kw", [dict(stochastic_rounding_tau=1.0, beam_size=2),
                                dict(code_selection_temperature=0.5, max_update_fraction=0.25)],
                         ids=["stochastic", "temperature"])
def test_beam_search_l2_random_constraints_properties(kw):
    scheme = JScheme(1, 4, in_group_size=4)
    target, cb, codes, scales = _l2_inputs(scheme, 16, 16, 5)
    args = (T(target), T(cb), T(codes), T(scales))
    outs = [bl2.beam_search_optimal_codes_l2(*args, generator=torch.Generator().manual_seed(s),
                                             **kw) for s in (1, 2, 1)]
    assert torch.equal(outs[0], outs[2])  # one generator state, one result
    assert not torch.equal(outs[0], outs[1])
    for out in outs:
        assert int(out.min()) >= 0 and int(out.max()) < 16
        if "max_update_fraction" in kw:
            changed = int((out != T(codes)).any(-1).sum())
            assert changed <= int(np.ceil(0.25 * 64))


def test_find_optimal_codebooks_matches_jax():
    rng = np.random.default_rng(6)
    K, S, gsz, G = 2, 8, 4, 64
    ref = rng.standard_normal((G, gsz)).astype(np.float32)
    cbs = rng.standard_normal((K, S, gsz)).astype(np.float32)
    codes = rng.integers(0, S, (G, K)).astype(np.int32)
    want = np.asarray(jbl2.find_optimal_codebooks(jnp.asarray(ref), jnp.asarray(cbs),
                                                  jnp.asarray(codes)))
    got = bl2.find_optimal_codebooks(T(ref), T(cbs), T(codes))
    recon = lambda c: np.asarray(c)[np.arange(K)[None, :], codes].sum(1)
    np.testing.assert_allclose(recon(f32(got)), recon(want), atol=1e-4)
    err = lambda c: float(((recon(c) - ref) ** 2).sum())
    assert err(f32(got)) <= err(cbs) + 1e-6


# --- the trainers ---------------------------------------------------------------

TINY = dict(hidden_size=64, intermediate_size=128)
FAMILY_CFGS = {
    "llama": (jllama, lambda **k: jllama.ModelConfig.tiny(**k),
              lambda **k: llama.ModelConfig.tiny(**k), llama),
    "falcon": (jfalcon, lambda **k: jfalcon.FalconConfig.tiny(**k),
               lambda **k: falcon.FalconConfig.tiny(**k), falcon),
    "mixtral": (jmixtral, lambda **k: jmixtral.MixtralConfig.tiny_moe(**k),
                lambda **k: mixtral.MixtralConfig.tiny_moe(**k), mixtral),
}


@functools.cache
def _pair(family="llama", layers=1):
    """(jcfg, cfg, (j_student, student), (j_teacher, teacher), jforward, forward):
    JAX's random f32 models and the port's copies."""
    jmod, jcfg_of, cfg_of, mod = FAMILY_CFGS[family]
    kw = dict(TINY, num_layers=layers) if family == "llama" else dict(num_layers=layers)
    jcfg, cfg = jcfg_of(**kw), cfg_of(**kw)
    jt = jmod.init_random_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    js = j_random_quantize(jax.random.PRNGKey(1),
                           jmod.init_random_params(jax.random.PRNGKey(8), jcfg, dtype=jnp.float32),
                           SCHEME_2X8)
    port = lambda p: params_from_numpy(to_numpy_tree(p), device="cpu")
    return jcfg, cfg, (js, port(js)), (jt, port(jt)), jmod.forward, mod.forward


def _ids(vocab, b, t, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _jax_leaves(tree):
    return [x for x in jax.tree.leaves(tree) if x is not None]


def test_make_distill_step_one_step():
    jcfg, cfg, (js, s), (jt, t), _, _ = _pair()
    ids = _ids(cfg.vocab_size, 2, 12)
    jopt = j_adamw(1e-3, b1=0.9, b2=0.95)
    jstate = jtrainer.init_train_state(js, jopt)
    jstep = jax.jit(jtrainer.make_distill_step(jcfg, jcfg, jopt))
    jstate, jloss = jstep(jstate, jt, jnp.asarray(ids))
    state = trainer.init_train_state(s, configurable_adamw(1e-3, b1=0.9, b2=0.95))
    state, loss = trainer.make_distill_step(cfg, cfg)(state, t, T(ids).long())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    pairs = pairs_by_path(jstate.trainable, state.trainable)
    assert len(pairs) == len(_jax_leaves(jstate.trainable))
    for got, want in pairs:
        np.testing.assert_allclose(f32(got), np.asarray(want, np.float32), rtol=1e-5,
                                   atol=2e-2 * 1e-3)
    assert state.step == 1


def _j_opts(pv):
    return j_adamw(pv.lr, b1=0.9, b2=0.95), j_adamw(pv.code_lr, b1=0.9, b2=0.95)


def _pv_states(js, s, pv, active_layers=None):
    jstate = jst.init_pv_state(js, *_j_opts(pv), active_layers=active_layers)
    state = st.init_pv_state(s, configurable_adamw(pv.lr, b1=0.9, b2=0.95),
                             configurable_adamw(pv.code_lr, b1=0.9, b2=0.95),
                             active_layers=active_layers)
    return jstate, state


@pytest.mark.parametrize("family,chunk",
                         [("llama", 8), ("llama", 0), ("falcon", 8), ("mixtral", 0)])
def test_pv_grad_fn_matches_jax(family, chunk):
    jcfg, cfg, (js, s), (jt, t), jfwd, fwd = _pair(family)
    if family == "mixtral":  # JAX's Mixtral forward takes neither return_hidden nor remat_blocks
        jfwd = lambda p, c, ids, remat_blocks=False, _f=jfwd: _f(p, c, ids)
    jpv, pv = jst.PVConfig(chunk_tokens=chunk), st.PVConfig(chunk_tokens=chunk)
    jstate, state = _pv_states(js, s, pv)
    ids = _ids(cfg.vocab_size, 2, 16)
    jloss, (jg_tr, jg_st) = jax.jit(jst.make_pv_step(jcfg, jcfg, jpv, forward_fn=jfwd).grad_fn)(
        jstate, jt, jnp.asarray(ids))
    fns = st.make_pv_step(cfg, cfg, pv, forward_fn=fwd)
    loss, (g_tr, g_st) = fns.grad_fn(state, t, T(ids).long())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tr_pairs, st_pairs = pairs_by_path(jg_tr, g_tr), pairs_by_path(jg_st, g_st)
    assert len(tr_pairs) == len(_jax_leaves(jg_tr)) and len(st_pairs) == len(_jax_leaves(jg_st))
    assert st_pairs  # every quantized projection has a buffer
    for got, want in tr_pairs + st_pairs:
        _grad_close(got, want)


def test_pv_apply_then_code_step_matches_jax():
    jcfg, cfg, (js, s), (jt, t), _, _ = _pair()
    kw = dict(lr=1e-3, code_lr=5e-2, max_code_change_per_step=0.25)
    jpv, pv = jst.PVConfig(**kw), st.PVConfig(**kw)
    jstate, state = _pv_states(js, s, pv)
    cont_opt, st_opt = _j_opts(pv)
    jfns = jst.make_pv_step(jcfg, jcfg, jpv, cont_opt=cont_opt, st_opt=st_opt)
    fns = st.make_pv_step(cfg, cfg, pv)
    for seed in (3, 4):
        ids = _ids(cfg.vocab_size, 2, 16, seed)
        jstate, _ = jax.jit(jfns.grad_step)(jstate, jt, jnp.asarray(ids))
        jstate = jfns.code_step(jstate, jax.random.PRNGKey(0))
        state, _ = fns.grad_step(state, t, T(ids).long())
        state = fns.code_step(state, torch.Generator().manual_seed(0))
    assert state.step == 2
    for pairs, lr in ((pairs_by_path(jstate.trainable, state.trainable), kw["lr"]),
                      (pairs_by_path(jstate.st_buffers, state.st_buffers), kw["code_lr"])):
        for got, want in pairs:
            np.testing.assert_allclose(f32(got), np.asarray(want, np.float32), rtol=1e-5,
                                       atol=2e-2 * lr)
    moved = 0
    for li in range(cfg.num_layers):
        for name in llama.QUANTIZABLE_PROJS:
            want = np.asarray(jstate.frozen["layers"][li][name].codes)
            got = state.frozen["layers"][li][name].codes.numpy()
            np.testing.assert_array_equal(got, want)
            moved += int((got != s["layers"][li][name].codes.numpy()).any(-1).sum())
    assert moved > 0  # the V step changed codes


def test_pv_code_update_windowed_form_equals_list_form():
    _, cfg, (_, s), _, _, _ = _pair(layers=2)
    pv = st.PVConfig(max_code_change_per_step=0.5, delta_decay=0.3)
    state = st.init_pv_state(s, configurable_adamw(1e-3), None, active_layers=(1,))
    with torch.no_grad():
        for buf in state.st_buffers[1].values():
            buf.add_(torch.randn(buf.shape, generator=torch.Generator().manual_seed(0)) * 0.05)
    win = st.PVState(trainable=state.trainable, frozen=state.frozen,
                     st_buffers={k: v.detach().clone()[None]
                                 for k, v in state.st_buffers[1].items()},
                     cont_opt=state.cont_opt, st_opt=None)
    listed = st.pv_code_update(state, pv)
    win = st.pv_code_update(win, pv, active=(1,))
    for name, buf in listed.st_buffers[1].items():
        assert torch.equal(win.st_buffers[name][0], buf.detach())
        assert torch.equal(win.frozen["layers"][1][name].codes,
                           listed.frozen["layers"][1][name].codes)
    assert all(torch.equal(listed.frozen["layers"][0][n].codes, s["layers"][0][n].codes)
               for n in llama.QUANTIZABLE_PROJS)


def test_grad_accumulation_equals_one_batch():
    _, cfg, (_, s), (_, t), _, _ = _pair()
    pv = st.PVConfig()
    state = st.init_pv_state(s, configurable_adamw(pv.lr), configurable_adamw(pv.code_lr))
    grad_fn = st.make_pv_step(cfg, cfg, pv).grad_fn
    ids = T(_ids(cfg.vocab_size, 4, 16)).long()
    _, g_full = grad_fn(state, t, ids)
    _, g_a = grad_fn(state, t, ids[:2])
    _, g_b = grad_fn(state, t, ids[2:])
    for full, a, b in zip(tree_leaves(g_full), tree_leaves(g_a), tree_leaves(g_b)):
        _grad_close((a + b) * 0.5, full.numpy())


def test_configurable_adamw_state_dict_round_trip_keeps_moment_dtypes():
    p = torch.randn(4, 3)
    opt = ConfigurableAdamW([p], lr=1e-2, amsgrad=True, exp_avg_dtype=torch.bfloat16)
    p.grad = torch.ones_like(p)
    opt.step()
    q = p.detach().clone()
    opt2 = ConfigurableAdamW([q], lr=1e-2, amsgrad=True, exp_avg_dtype=torch.bfloat16)
    opt2.load_state_dict(opt.state_dict())
    a, b = opt.state_of(p), opt2.state_of(q)
    assert b.step == 1 and b.exp_avg.dtype == torch.bfloat16 and b.exp_avg_sq.dtype == torch.float32
    assert torch.equal(a.exp_avg, b.exp_avg) and torch.equal(a.v_hat_max, b.v_hat_max)
