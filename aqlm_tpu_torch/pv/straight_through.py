"""Straight-through PV-tuning: the full P + V alternating update (PyTorch
counterpart of ``aqlm_tpu.pv.straight_through``, its default unrolled path).

One PV step:

1. the gradient pass: the loss sees each ST-active quantized projection as
   W_eff = dequant(codes, codebooks, scales) + (st - st.detach()), so
   dL/d(st) equals dL/dW (the straight-through estimator) while the
   codebooks and scales get their chain-rule gradients through the
   dequantization: on the card B13 forward and B14 backward
   (``ops.dequant._DequantGroupsKernel``);
2. the optimizers update the continuous params and the ST buffers;
3. the V step: codes <- the L2 beam search toward each updated buffer
   (``calib.beam_search_l2``), under the max-change, trust-ratio,
   temperature and force-update constraints;
4. delta-decay: buffer <- delta * dequant(new codes) + (1 - delta) * buffer.

The KL is chunked (``pv.losses.chunked_kl_loss``) unless ``chunk_tokens`` is
0, and each block is recomputed in the backward (``remat_blocks``). ST
buffers exist only for the active layers (``active_layers``); the others
forward codes-resident through the differentiable reference-mode dequant.
``pv.host.HostSTManager`` keeps every layer's buffers in host memory and
rotates the window; ``pv.teacher`` streams a host-resident teacher's hidden
states (``teacher_kind="hidden"``).

Unlike JAX, the state holds its ``torch.optim.Optimizer`` objects
(``init_pv_state`` builds them) and the steps update it in place. The
scanned student forward (``PVConfig(scan_blocks=True)``) is not ported
(ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from aqlm_tpu_torch.calib.beam_search_l2 import beam_search_optimal_codes_l2
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS
from aqlm_tpu_torch.ops.dequant import AqlmWeight, dequantize_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported
from aqlm_tpu_torch.pv.losses import chunked_kl_loss, kl_divergence_loss
from aqlm_tpu_torch.pv.trainer import (
    merge_trainable,
    split_trainable,
    trainable_copy,
    tree_leaves,
    tree_map,
)

__all__ = ["PVConfig", "PVState", "PVStepFns", "init_pv_state", "make_pv_step",
           "pv_code_update", "materialize_st_params"]


@dataclasses.dataclass(frozen=True)
class PVConfig:
    """PV hyperparameters, JAX's fields and defaults."""

    lr: float = 1e-4  # continuous params (codebooks, scales, unquantized params)
    code_lr: float = 1e-3  # straight-through buffers
    beam_size: int = 1
    delta_decay: float = 0.0
    max_code_change_per_step: float = 1e-2
    code_trust_ratio: float | None = None
    code_selection_temperature: float = 0.0
    force_code_update: bool = False
    stochastic_rounding_tau: float = 0.0
    # the chunked lm_head + KL (tokens a chunk); 0 = the full [B, T, V] logits
    chunk_tokens: int = 256
    # recompute each transformer block in the student's backward
    remat_blocks: bool = True
    # the scanned student forward and its options: not ported
    scan_blocks: bool = False
    scan_remat: str = "manual"
    scan_segment_layers: int = 8
    scan_dequant: str = "auto"

    def __post_init__(self):
        if self.scan_blocks:
            raise not_ported("the scanned student forward (PVConfig(scan_blocks=True))", "A13")


@dataclasses.dataclass
class PVState:
    trainable: Any
    frozen: Any
    st_buffers: Any  # [layers] of {proj: [out, in] f32} ({} = inactive), or {proj: [W, out, in]}
    cont_opt: torch.optim.Optimizer
    st_opt: torch.optim.Optimizer | None  # None: the buffers are updated elsewhere (HostSTManager)
    step: int = 0

    data_fields = ("trainable", "frozen", "st_buffers", "cont_opt", "st_opt")


class PVStepFns(NamedTuple):
    """grad_step(state, teacher, ids[, mask]) -> (state, loss): grad + apply.
    code_step(state, generator[, active]) -> state: the V phase.
    grad_fn(state, teacher, ids[, mask]) -> (loss, (g_trainable, g_st)) and
    apply_fn(state, grads, scale) -> state split the step for gradient
    accumulation."""

    grad_step: Callable
    code_step: Callable
    grad_fn: Callable
    apply_fn: Callable


def _quantized_weight_of(q: QuantizedLinear) -> AqlmWeight:
    assert q.mode == "reference", "PV-tuning operates on reference-mode params"
    return AqlmWeight(codes=q.codes, codebooks=q.codebooks, scales=q.scales, bias=q.bias,
                      scheme=q.scheme)


def _st_init(params: dict, active_layers=None) -> list:
    """Each active layer's quantized projections dequantized to f32 (B13 on the card)."""
    buffers = []
    with torch.no_grad():
        for li, layer in enumerate(params["layers"]):
            entry = {}
            if active_layers is None or li in active_layers:
                for name in QUANTIZABLE_PROJS:
                    lin = layer.get(name)
                    if isinstance(lin, QuantizedLinear):
                        entry[name] = dequantize_weight(_quantized_weight_of(lin),
                                                        dtype=torch.float32)
            buffers.append(entry)
    return buffers


def materialize_st_params(params: dict, st_buffers) -> dict:
    """Swap the ST-active quantized projections for DenseLinear(W_eff).

    Layers without buffers keep their QuantizedLinear, whose forward
    dequantizes differentiably (the codebooks and scales still get
    gradients)."""
    out = dict(params)
    layers = []
    for layer, bufs in zip(params["layers"], st_buffers):
        new_layer = dict(layer)
        for name, st in bufs.items():
            q: QuantizedLinear = layer[name]
            w = dequantize_weight(_quantized_weight_of(q), dtype=torch.float32)
            new_layer[name] = DenseLinear(weight=w + (st - st.detach()), bias=q.bias)
        layers.append(new_layer)
    out["layers"] = layers
    return out


def init_pv_state(params: dict, cont_opt: Callable, st_opt: Callable | None, *,
                  active_layers=None) -> PVState:
    """Split ``params``, copy the trainable leaves, make the active layers' ST
    buffers and build the optimizers over them: ``cont_opt(tensors)`` and
    ``st_opt(tensors)`` (e.g. ``pv.configurable_adamw(1e-4)``); ``st_opt``
    None (or no active layer) leaves the buffers to the caller."""
    trainable, frozen = split_trainable(params)
    trainable = trainable_copy(trainable)
    st = trainable_copy(_st_init(params, active_layers))
    st_leaves = tree_leaves(st)
    return PVState(trainable=trainable, frozen=frozen, st_buffers=st,
                   cont_opt=cont_opt(tree_leaves(trainable)),
                   st_opt=st_opt(st_leaves) if st_opt is not None and st_leaves else None)


def _head_and_embed(params):
    head = params.get("lm_head")
    if head is not None:
        return head.weight, None
    return None, params["embed"]


def _unflatten(tree, values):
    it = iter(values)
    return tree_map(lambda t: None if t is None else next(it), tree)


def _set_grads(tree, grads, scale: float) -> None:
    for p, g in zip(tree_leaves(tree), tree_leaves(grads)):
        p.grad = g * scale


def make_pv_step(student_cfg, teacher_cfg, pv: PVConfig, *, forward_fn=llama.forward,
                 teacher_kind: str = "params") -> PVStepFns:
    """The PV step functions (see ``PVStepFns``).

    teacher_kind="params": ``teacher`` is a params tree, forwarded in the step
    without gradients. teacher_kind="hidden": ``teacher`` is
    {hidden [B, T, H], head [V, H] or None, embed (tied heads) or None},
    computed outside the step (``pv.teacher``)."""
    assert teacher_kind in ("params", "hidden"), teacher_kind

    def loss_fn(trainable, st, frozen, teacher, input_ids, mask):
        eff = materialize_st_params(merge_trainable(trainable, frozen), st)
        if pv.chunk_tokens:
            s_hidden, _ = forward_fn(eff, student_cfg, input_ids, return_hidden=True,
                                     remat_blocks=pv.remat_blocks)
            if teacher_kind == "hidden":
                t_hidden = teacher["hidden"]
                t_head, t_embed = teacher.get("head"), teacher.get("embed")
            else:
                with torch.no_grad():
                    t_hidden, _ = forward_fn(teacher, teacher_cfg, input_ids, return_hidden=True)
                t_head, t_embed = _head_and_embed(teacher)
            s_head, s_embed = _head_and_embed(eff)
            return chunked_kl_loss(
                s_hidden, t_hidden.detach(), s_head, t_head, student_embed=s_embed,
                teacher_embed=t_embed, mask=mask, chunk_tokens=pv.chunk_tokens,
                softcap=student_cfg.logit_softcap,
                logit_scale=getattr(student_cfg, "logit_scale", None))
        assert teacher_kind == "params", "the full-logit KL needs teacher params"
        student_logits, _ = forward_fn(eff, student_cfg, input_ids, remat_blocks=pv.remat_blocks)
        with torch.no_grad():
            teacher_logits, _ = forward_fn(teacher, teacher_cfg, input_ids)
        return kl_divergence_loss(student_logits, teacher_logits, mask)

    def grad_fn(state: PVState, teacher, input_ids, mask=None):
        for buf in tree_leaves(state.st_buffers):  # buffers given from outside (HostSTManager)
            buf.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(state.trainable, state.st_buffers, state.frozen, teacher, input_ids,
                           mask)
            leaves = tree_leaves(state.trainable) + tree_leaves(state.st_buffers)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        n_tr = len(tree_leaves(state.trainable))
        return loss.detach(), (_unflatten(state.trainable, grads[:n_tr]),
                               _unflatten(state.st_buffers, grads[n_tr:]))

    def apply_fn(state: PVState, grads, scale: float = 1.0):
        g_tr, g_st = grads
        for tree, g, opt in ((state.trainable, g_tr, state.cont_opt),
                             (state.st_buffers, g_st, state.st_opt)):
            if opt is None:
                continue
            _set_grads(tree, g, scale)
            opt.step()
            opt.zero_grad(set_to_none=True)
        state.step += 1
        return state

    def grad_step(state: PVState, teacher, input_ids, mask=None):
        loss, grads = grad_fn(state, teacher, input_ids, mask)
        return apply_fn(state, grads), loss

    def code_step(state: PVState, generator: torch.Generator | None = None, active=None):
        return pv_code_update(state, pv, generator, active=active)

    return PVStepFns(grad_step, code_step, grad_fn, apply_fn)


@torch.no_grad()
def pv_code_update(state: PVState, pv: PVConfig, generator: torch.Generator | None = None,
                   active=None) -> PVState:
    """The V step: beam-search each ST-active projection's codes toward its
    buffer, then delta-mix the buffer (in place, so an optimizer over it
    keeps it).

    st_buffers is the per-layer list (active = the layers with entries) or
    the windowed stack {proj: [W, out, in]}, for which ``active`` (window slot
    -> layer index) must be given. ``generator`` (on the buffers' device) is
    drawn from only under stochastic rounding or a selection temperature."""
    params = merge_trainable(state.trainable, state.frozen)
    n_layers = len(params["layers"])
    if isinstance(state.st_buffers, dict):
        assert active is not None, "windowed st_buffers need the active layer indices"
        st_list = [{name: stack[active.index(li)] for name, stack in state.st_buffers.items()}
                   if li in active else {} for li in range(n_layers)]
    else:
        st_list = state.st_buffers
    frozen = dict(state.frozen)
    frozen["layers"] = [dict(layer) for layer in state.frozen["layers"]]
    for li, (layer, bufs) in enumerate(zip(params["layers"], st_list)):
        for name, st in bufs.items():
            q: QuantizedLinear = layer[name]
            codebooks, scales = q.codebooks.detach(), q.scales.detach()
            new_codes = beam_search_optimal_codes_l2(
                st.detach(), codebooks, q.codes, scales, beam_size=pv.beam_size,
                stochastic_rounding_tau=pv.stochastic_rounding_tau,
                force_update=pv.force_code_update,
                max_update_fraction=pv.max_code_change_per_step,
                code_selection_temperature=pv.code_selection_temperature,
                trust_ratio=pv.code_trust_ratio, generator=generator)
            frozen["layers"][li][name] = dataclasses.replace(frozen["layers"][li][name],
                                                             codes=new_codes)
            if pv.delta_decay != 0:
                w_new = dequantize_weight(AqlmWeight(codes=new_codes, codebooks=codebooks,
                                                     scales=scales, bias=None, scheme=q.scheme),
                                          dtype=torch.float32)
                st.copy_(pv.delta_decay * w_new + (1.0 - pv.delta_decay) * st)
    state.frozen = frozen
    return state
