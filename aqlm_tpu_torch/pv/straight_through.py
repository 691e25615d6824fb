"""Straight-through PV-tuning: the full P + V alternating update (PyTorch
counterpart of ``aqlm_tpu.pv.straight_through``).

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

``PVConfig(scan_blocks=True)`` runs the student through
``scanned_student_hidden`` instead: a loop over the layers (JAX's
``lax.scan``) whose backward keeps one block's dense weights at a time. Its
"manual" projections (``_make_manual_st_proj``) save only x and the codes,
codebooks and scales, and re-dequantize in the backward: on the card B13 to
W^T forward and backward, B14 for the codebook gradient. The attention and
SiLU glue recompute their f32 intermediates in the backward
(``_AttentionRemat``, ``_SiluMulRemat``).

Unlike JAX, the state holds its ``torch.optim.Optimizer`` objects
(``init_pv_state`` builds them) and the steps update it in place.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from aqlm_tpu_torch.calib.beam_search_l2 import beam_search_optimal_codes_l2
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear, attention
from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS
from aqlm_tpu_torch.ops import kernels
from aqlm_tpu_torch.ops.dequant import AqlmWeight, dequantize_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.pv.losses import chunked_kl_loss, kl_divergence_loss
from aqlm_tpu_torch.pv.trainer import (
    merge_trainable,
    split_trainable,
    trainable_copy,
    tree_leaves,
    tree_map,
)

__all__ = ["PVConfig", "PVState", "PVStepFns", "init_pv_state", "make_pv_step",
           "pv_code_update", "materialize_st_params", "scanned_student_hidden"]


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
    # the student as ``scanned_student_hidden``: a loop over homogeneous
    # reference-mode Llama-family layers whose backward holds one block's
    # dense weights at a time; needs the chunked loss
    scan_blocks: bool = False
    # what its backward recomputes: "manual" (the custom-backward projections
    # and glue), "dequant" (a checkpoint per projection), "block" (a
    # checkpoint per block), "none"
    scan_remat: str = "manual"
    # layers a segment: a loop boundary only (JAX chains scans of this depth)
    scan_segment_layers: int = 8
    # the "manual" projections' dequant: "auto" (B13/B14 on the card for
    # Kx<=8-bit, out_group_size 1, [OUT] scales; the plain gather otherwise),
    # "kernel" or "xla" to force one
    scan_dequant: str = "auto"


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
    """grad_step(state, teacher, ids[, mask, window_start]) -> (state, loss):
    grad + apply (``window_start`` with the windowed st_buffers of
    ``scan_blocks``). code_step(state, generator[, active]) -> state: the V
    phase. grad_fn(state, teacher, ids[, mask, window_start]) ->
    (loss, (g_trainable, g_st)) and
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


# ---------------------------------------------------------------------------
# the scanned student: recompute-in-backward glue and projections
# ---------------------------------------------------------------------------


class _AttentionRemat(torch.autograd.Function):
    """``models.common.attention`` whose backward recomputes the f32 softmax
    probabilities from (q, k, v, mask), the only tensors it saves, so the
    [B, Hkv, rep, Tq, Tk] probabilities of every layer are not held until the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        b, tq, hq, d = q.shape
        hkv = k.shape[2]
        rep = hq // hkv
        scale = d ** -0.5
        qs = (q.float() * scale).to(q.dtype).reshape(b, tq, hkv, rep, d)
        m = mask[:, :, None, :, :]
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qs.float(), k.float())
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
        p = torch.softmax(logits, dim=-1)  # [b, hkv, rep, tq, tk] f32, transient
        del logits
        gr = g.float().reshape(b, tq, hkv, rep, d)
        dv = torch.einsum("bhrqk,bqhrd->bkhd", p, gr).to(v.dtype)
        dp = torch.einsum("bqhrd,bkhd->bhrqk", gr, v.float())
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        ds = torch.where(m, ds, torch.zeros_like(ds))
        dqs = torch.einsum("bhrqk,bkhd->bqhrd", ds, k.float())
        dq = (dqs * scale).reshape(b, tq, hq, d).to(q.dtype)
        dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qs.float()).to(k.dtype)
        return dq, dk, dv, None


class _SiluMulRemat(torch.autograd.Function):
    """silu(gate) * up (SiLU in f32, as ``llama._block``) saving only (gate,
    up) in their own dtype; the backward recomputes the SiLU in f32."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return torch.nn.functional.silu(gate.float()).to(up.dtype) * up

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        g32 = gate.float()
        s = torch.sigmoid(g32)
        gy = g.float()
        dgate = (gy * up.float() * (s + g32 * s * (1.0 - s))).to(gate.dtype)
        dup = (gy * (g32 * s)).to(up.dtype)
        return dgate, dup


def _attention_remat(q, k, v, mask):
    return _AttentionRemat.apply(q, k, v, mask)


def _silu_mul_remat(gate, up):
    return _SiluMulRemat.apply(gate, up)


def _manual_dequant_t(codes, cbs, scales, scheme, dtype, dequant_impl: str):
    """W^T [IN, OUT] in ``dtype``. "kernel": ``kernels.dequantize_onehot``
    (B13 on the card, its plain version on the CPU: codebook entries rounded
    to bf16, summed in f32, times the [OUT] scales), a transposed view of
    the kernel's row-major W; "xla": the plain differentiable gather
    (``dequantize_weight``)."""
    if dequant_impl == "kernel":
        # the kernel's epilogue and _dq_grads assume [OUT] scales and og == 1
        if scheme.out_group_size != 1:
            raise ValueError(f"the kernel dequant needs out_group_size 1, got {scheme}")
        if scales.ndim != 1:
            raise ValueError("kernel dequant path needs per-out scales [OUT]; per-group "
                             f"scales {tuple(scales.shape)} use dequant_impl='xla'")
        return kernels.dequantize_onehot(codes.permute(2, 1, 0), cbs[:, :, 0, :], scales,
                                         group=scheme.in_group_size, dtype=dtype)
    return dequantize_weight(AqlmWeight(codes=codes, codebooks=cbs, scales=scales, bias=None,
                                        scheme=scheme), dtype=dtype).t()


def _dq_grads(codes, cbs, scales, w, gw, scheme):
    """(dcbs [K, S, 1, g], dscales [OUT]) from the f32 W [OUT, IN] and dL/dW.

    dscales[o] = sum_i gw[o, i] W[o, i] / scales[o]; dcbs[k, s] = the sum over
    the groups whose k-th code is s of scales[o] * gw's group: B14 on the
    card (its plain version on the CPU) for uint8 codes, at most
    ``CB_GRAD_MAX_SEGMENTS`` segments; a plain ``index_add_`` past them."""
    g_ = scheme.in_group_size
    out_f = gw.shape[0]
    ig = gw.shape[1] // g_
    safe = torch.where(scales.abs() > 1e-12, scales, torch.ones_like(scales))
    dscales = ((gw * w).sum(dim=1) / safe).to(scales.dtype)
    data = (gw.reshape(out_f, ig, g_) * scales[:, None, None]).reshape(-1, g_)
    S, K = scheme.codebook_size, scheme.num_codebooks
    flat = codes.reshape(-1, K)
    if S <= kernels.CB_GRAD_MAX_SEGMENTS and codes.dtype == torch.uint8:
        dcbs = kernels.cb_grad_segment(flat, data, S)
    else:
        idx = flat.long() % S  # 16-bit codes are stored signed
        dcbs = torch.stack([torch.zeros((S, g_), dtype=torch.float32, device=data.device)
                            .index_add_(0, idx[:, k], data) for k in range(K)])
    return dcbs[:, :, None, :].to(cbs.dtype), dscales


class _ManualSTProj(torch.autograd.Function):
    """y = x @ dequant(codes)^T (+ bias) with a hand-written backward: it
    saves x, codes, codebooks and scales (and the layer index), never the
    dense W nor the ST window, re-dequantizes W in f32, and routes dL/dW into
    the window slot of layer ``li`` (the straight-through estimator) while
    the codebooks and scales get their chain-rule gradients."""

    @staticmethod
    def forward(ctx, x, codes, cbs, scales, bias, st_arr, li, start, spec):
        scheme, compute_dtype, use_st, win, has_bias, dequant_impl = spec
        wt = _manual_dequant_t(codes, cbs, scales, scheme, compute_dtype, dequant_impl)
        y = torch.matmul(x, wt.to(x.dtype))
        if has_bias:
            y = y + bias.to(y.dtype)
        ctx.save_for_backward(x, codes, cbs, scales)
        ctx.li, ctx.start, ctx.spec = li, start, spec
        ctx.st_dims = None if st_arr is None else tuple(st_arr.shape)
        return y

    @staticmethod
    def backward(ctx, g):
        x, codes, cbs, scales = ctx.saved_tensors
        scheme, _, use_st, win, has_bias, dequant_impl = ctx.spec
        li, start = ctx.li, ctx.start
        gf = g.float()
        out_f, in_f = gf.shape[-1], x.shape[-1]
        gw = gf.reshape(-1, out_f).t() @ x.float().reshape(-1, in_f)  # dL/dW [OUT, IN]
        if dequant_impl == "kernel":
            w = _manual_dequant_t(codes, cbs, scales, scheme, torch.float32, dequant_impl).t()
            dx = torch.matmul(gf, w).to(x.dtype)
            dcbs, dscales = _dq_grads(codes, cbs, scales, w, gw, scheme)
        else:
            with torch.enable_grad():
                c = cbs.detach().requires_grad_(True)
                s = scales.detach().requires_grad_(True)
                w = dequantize_weight(AqlmWeight(codes=codes, codebooks=c, scales=s, bias=None,
                                                 scheme=scheme), dtype=torch.float32)
            dx = torch.matmul(gf, w.detach()).to(x.dtype)
            dcbs, dscales = torch.autograd.grad(w, (c, s), gw)
        del w
        dst = None
        if use_st and start <= li < start + win:
            if win == 1:  # JAX's window-of-one form: no zeros and scatter
                dst = gw[None]
            else:
                dst = torch.zeros(ctx.st_dims, dtype=torch.float32, device=gw.device)
                dst[li - start] = gw
        dbias = gf.reshape(-1, out_f).sum(dim=0) if has_bias else None
        return (dx, None, dcbs.to(cbs.dtype), dscales.to(scales.dtype), dbias, dst, None, None,
                None)


def _make_manual_st_proj(scheme, compute_dtype, use_st, win, has_bias, dequant_impl: str = "xla"):
    """The straight-through projection of ``scan_remat="manual"``:
    ``f(x, codes, cbs, scales, bias, st_arr, li, start) -> y`` with
    ``_ManualSTProj``'s backward. The primal is x @ dequant(codes)^T (the ST
    correction is zero); dL/dW goes to ``st_arr[li - start]`` when layer
    ``li`` lies in the window of ``win`` layers from ``start`` (nowhere
    otherwise). dequant_impl: "kernel" (B13/B14; [OUT] scales,
    out_group_size 1) or "xla" (the plain gather, differentiated by
    autograd)."""
    if dequant_impl not in ("xla", "kernel"):
        raise ValueError(f"dequant_impl must be xla or kernel, got {dequant_impl!r}")
    spec = (scheme, compute_dtype, use_st, win, has_bias, dequant_impl)

    def f(x, codes, cbs, scales, bias, st_arr, li, start):
        return _ManualSTProj.apply(x, codes, cbs, scales, bias, st_arr, int(li), int(start),
                                   spec)

    return f


class _FnLinear:
    """A weightless linear for ``apply_linear``: ``apply(x)`` does the matmul."""

    bias = None

    def __init__(self, fn):
        self.apply = fn


def _proj_apply(x, codes, cbs, scales, bias, st_arr, li, *, scheme, compute_dtype, start, win):
    """One projection of the "dequant", "block" and "none" forms: the dequant
    (B13/B14 on the card), the ST correction in the window, then the matmul,
    one unit that "dequant" checkpoints (the matmul inside, so the dense W is
    no saved input)."""
    w = dequantize_weight(AqlmWeight(codes=codes, codebooks=cbs, scales=scales, bias=None,
                                     scheme=scheme), dtype=compute_dtype)
    if st_arr is not None and start <= li < start + win:
        stw = st_arr[li - start]
        w = (w.float() + (stw - stw.detach())).to(compute_dtype)
    y = torch.matmul(x, w.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def scanned_student_hidden(params: dict, st_buffers, cfg, input_ids, window_start=None,
                           remat: str = "manual", segment_layers: int = 8,
                           dequant_impl: str = "auto"):
    """The student's post-final-norm hidden states, layer by layer, with the
    straight-through correction on a contiguous window of layers.

    Every projection of every layer must be a reference-mode QuantizedLinear
    of one scheme (a Llama-family student). ``st_buffers`` is the per-layer
    list of ``init_pv_state`` (its non-empty entries a contiguous window) or
    the windowed stack {proj: [W, out, in]} with ``window_start`` (window
    slot w is layer window_start + w).

    remat: "manual" (``_make_manual_st_proj`` projections: the backward
    re-dequantizes, the window is never saved), "dequant" (each projection's
    dequant + ST correction + matmul under ``torch.utils.checkpoint``),
    "block" (a checkpoint around each block) or "none". Every form recomputes
    the attention probabilities and the SiLU in the backward
    (``_AttentionRemat``, ``_SiluMulRemat``). ``segment_layers`` splits the
    loop into segments: a loop boundary, with no effect on the values (JAX
    chains scans of this depth). ``dequant_impl`` ("auto", "kernel", "xla")
    applies to "manual": "auto" picks "kernel" for codes of at most 8 bits,
    out_group_size 1 and [OUT] scales on the card, "xla" otherwise (per-group
    scales: the plain differentiable gather)."""
    if remat not in ("dequant", "manual", "block", "none"):
        raise ValueError(f"remat must be dequant, manual, block or none, got {remat!r}")
    layers = params["layers"]
    l0 = layers[0]
    scheme = getattr(l0.get(QUANTIZABLE_PROJS[0]), "scheme", None)
    for layer in layers:
        for name in QUANTIZABLE_PROJS:
            q = layer.get(name)
            if not (isinstance(q, QuantizedLinear) and q.mode == "reference"
                    and q.scheme == scheme and (q.bias is None) == (l0[name].bias is None)):
                raise ValueError("scan_blocks needs homogeneous reference-mode layers; "
                                 f"{name!r} is {type(q)}")
    compute_dtype = params["embed"].dtype

    st_stack, start, win = {}, 0, 0
    if isinstance(st_buffers, dict):
        if st_buffers:
            if window_start is None:
                raise ValueError("windowed st_buffers need window_start")
            st_stack = st_buffers
            start = int(window_start)
            win = next(iter(st_buffers.values())).shape[0]
    else:
        active = [li for li, e in enumerate(st_buffers) if e]
        if active:
            start, win = active[0], len(active)
            if active != list(range(start, start + win)):
                raise ValueError(f"scan_blocks needs a contiguous active window, got {active}")
            st_stack = {name: torch.stack([st_buffers[li][name] for li in active])
                        for name in QUANTIZABLE_PROJS}

    x, positions = llama.embed_and_positions(params, cfg, input_ids, None, 0)

    if remat == "manual":
        if dequant_impl == "auto":
            kernel_ok = (scheme.nbits_per_codebook <= 8 and scheme.out_group_size == 1
                         and all(l0[name].scales.ndim == 1 for name in QUANTIZABLE_PROJS))
            on_card = l0[QUANTIZABLE_PROJS[0]].codes.device.type == "cuda"
            dequant_impl = "kernel" if kernel_ok and on_card else "xla"
        manual_fns = {name: _make_manual_st_proj(scheme, compute_dtype, name in st_stack, win,
                                                 l0[name].bias is not None, dequant_impl)
                      for name in QUANTIZABLE_PROJS}
    else:
        proj = partial(_proj_apply, scheme=scheme, compute_dtype=compute_dtype, start=start,
                       win=win)
        if remat == "dequant":
            proj = partial(checkpoint, proj, use_reentrant=False)

    def block(x, li):
        layer = {"input_norm": layers[li]["input_norm"],
                 "post_attn_norm": layers[li]["post_attn_norm"]}
        for name in QUANTIZABLE_PROJS:
            q = layers[li][name]
            args = (q.codes, q.codebooks, q.scales, q.bias, st_stack.get(name), li)
            if remat == "manual":
                fn = lambda x, _f=manual_fns[name], _a=args: _f(x, *_a, start)
            else:
                fn = lambda x, _a=args: proj(x, *_a)
            layer[name] = _FnLinear(fn)
        return llama._block(x, layer, cfg, positions, attention_fn=_attention_remat,
                            act_mul_fn=_silu_mul_remat)

    n = len(layers)
    seg = max(1, min(segment_layers, n)) if segment_layers else n
    for s0 in range(0, n, seg):  # a segment is a loop boundary: the values are the same
        for li in range(s0, min(s0 + seg, n)):
            x = checkpoint(block, x, li, use_reentrant=False) if remat == "block" else block(x, li)
    return llama.final_norm(x, params, cfg)


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
    if pv.scan_blocks and not pv.chunk_tokens:
        raise ValueError("scan_blocks requires the chunked loss (chunk_tokens > 0)")

    def loss_fn(trainable, st, frozen, teacher, input_ids, mask, window_start=None):
        params = merge_trainable(trainable, frozen)
        if pv.chunk_tokens:
            if pv.scan_blocks:
                eff = params
                s_hidden = scanned_student_hidden(
                    params, st, student_cfg, input_ids, window_start, remat=pv.scan_remat,
                    segment_layers=pv.scan_segment_layers, dequant_impl=pv.scan_dequant)
            else:
                eff = materialize_st_params(params, st)
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
        eff = materialize_st_params(params, st)
        student_logits, _ = forward_fn(eff, student_cfg, input_ids, remat_blocks=pv.remat_blocks)
        with torch.no_grad():
            teacher_logits, _ = forward_fn(teacher, teacher_cfg, input_ids)
        return kl_divergence_loss(student_logits, teacher_logits, mask)

    def grad_fn(state: PVState, teacher, input_ids, mask=None, window_start=None):
        for buf in tree_leaves(state.st_buffers):  # buffers given from outside (HostSTManager)
            buf.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(state.trainable, state.st_buffers, state.frozen, teacher, input_ids,
                           mask, window_start)
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

    def grad_step(state: PVState, teacher, input_ids, mask=None, window_start=None):
        loss, grads = grad_fn(state, teacher, input_ids, mask, window_start)
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
