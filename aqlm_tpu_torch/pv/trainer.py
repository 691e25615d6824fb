"""The continuous-parameter distillation trainer, the "P" phase of
PV-tuning (PyTorch counterpart of ``aqlm_tpu.pv.trainer``), and the
trainable/frozen split of a parameter tree it and the other trainers use.

A tree is dicts, lists, weight dataclasses (``QuantizedLinear``,
``DenseLinear``, ``LoraLinear`` around its base: their ``data_fields``) and
tensors. Float tensors train; integer tensors (the
codes) freeze. The split gives two trees of the same shape with ``None``
holes; ``merge_trainable`` fills each hole from the other tree.

``make_distill_step`` trains the codebooks, scales and unquantized params of
a reference-mode student against a teacher's logits (KL), the codes frozen.
Unlike JAX, the state holds its ``torch.optim.Optimizer`` and the step
updates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from aqlm_tpu_torch.models import llama

__all__ = ["split_trainable", "merge_trainable", "tree_map", "tree_leaves", "TrainState",
           "init_train_state", "make_distill_step"]


def tree_map(fn, *trees):
    """``fn`` over the tensor (or None) leaves of trees of one shape."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *items) for items in zip(*trees))
    if dataclasses.is_dataclass(first) and hasattr(first, "data_fields"):
        return dataclasses.replace(first, **{
            n: tree_map(fn, *(getattr(t, n) for t in trees)) for n in first.data_fields})
    if first is None or isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree``, in ``tree_map``'s order (None skipped)."""
    found = []
    tree_map(lambda t: found.append(t) if t is not None else None, tree)
    return found


def split_trainable(params):
    """(trainable, frozen): float leaves train, integer leaves (codes) freeze."""
    is_float = lambda x: x is not None and x.is_floating_point()
    trainable = tree_map(lambda x: x if is_float(x) else None, params)
    frozen = tree_map(lambda x: None if is_float(x) else x, params)
    return trainable, frozen


def merge_trainable(trainable, frozen):
    return tree_map(lambda a, b: b if a is None else a, trainable, frozen)


def trainable_copy(trainable):
    """The trainable tree with every leaf a fresh tensor that requires grad
    (the optimizers' params), so the tree it was made from stays as it was."""
    return tree_map(lambda t: None if t is None else t.detach().clone().requires_grad_(True),
                    trainable)


@dataclasses.dataclass
class TrainState:
    trainable: Any
    frozen: Any
    optimizer: torch.optim.Optimizer
    step: int = 0

    data_fields = ("trainable", "frozen", "optimizer")


def init_train_state(params,
                     make_optimizer: Callable[[list], torch.optim.Optimizer]) -> TrainState:
    """Split ``params`` and build the optimizer over copies of the trainable
    leaves (``make_optimizer(tensors)``, e.g. ``pv.configurable_adamw(1e-4)``)."""
    trainable, frozen = split_trainable(params)
    trainable = trainable_copy(trainable)
    return TrainState(trainable=trainable, frozen=frozen,
                      optimizer=make_optimizer(tree_leaves(trainable)))


def make_distill_step(student_cfg, teacher_cfg, *, forward_fn: Callable = llama.forward):
    """The KL-distillation step:
    ``step(state, teacher_params, input_ids, mask=None) -> (state, loss)``.

    The teacher forward runs without gradients; the student's gradients reach
    its codebooks, scales, norms and embeddings through the reference-mode
    dequantization (B13 forward, B14 backward on the card). ``loss`` is the
    step's loss before the update, detached."""
    from aqlm_tpu_torch.pv.losses import kl_divergence_loss

    def step(state: TrainState, teacher_params, input_ids, mask=None):
        with torch.no_grad():
            teacher_logits, _ = forward_fn(teacher_params, teacher_cfg, input_ids)
        with torch.enable_grad():
            params = merge_trainable(state.trainable, state.frozen)
            student_logits, _ = forward_fn(params, student_cfg, input_ids)
            loss = kl_divergence_loss(student_logits, teacher_logits, mask)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step
