"""LoRA finetuning on frozen quantized models (PyTorch counterpart of
``aqlm_tpu.pv.lora``).

Adapters (``models.common.LoraLinear``) train through the serving matmul's
activation-only backward (``ops/runtime.py``: B10 in int8 mode, B5 or B13
in codes mode), so codes, codebooks and scales never receive gradients and
the optimizer state covers the adapters alone.

Flow: ``attach_lora`` wraps target projections of a dense or reference-mode
model (serving layouts are wrapped by the caller, e.g. through
``models.quantize.map_quantized_linears``); ``split_lora`` gives (adapters,
frozen) trees of one shape (``pv.trainer.merge_trainable`` joins them);
``init_lora_state`` builds the optimizer over the adapters; the step of
``make_lora_step`` runs the forward, the LM loss, ``backward()`` and the
optimizer's ``step()``. ``merge_lora`` folds adapters into dense bases and
keeps quantized bases wrapped.

Unlike JAX, the step updates the state in place; ``init_lora_state`` copies
the adapters, so the tree it was given stays as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear, LoraLinear
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.pv.losses import cross_entropy_loss
from aqlm_tpu_torch.pv.trainer import merge_trainable, trainable_copy, tree_leaves, tree_map

__all__ = [
    "attach_lora",
    "split_lora",
    "merge_lora",
    "make_lora_step",
    "init_lora_state",
    "LoraTrainState",
]

# unfused training-time projection names
DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _true_in_features(lin) -> int:
    if isinstance(lin, DenseLinear):
        return lin.weight.shape[1]
    if lin.codes is None:
        raise ValueError("attach_lora needs the canonical (mode='reference') layout; int8/"
                         "codes serving layouts pad in_features")
    return lin.codes.shape[1] * lin.scheme.in_group_size


def attach_lora(params: dict, generator: torch.Generator, *, r: int = 8, alpha: float = 16.0,
                targets: tuple = DEFAULT_TARGETS, dtype=torch.float32) -> dict:
    """Wrap the target projections of every layer in LoRA: lora_a normal / sqrt(r)
    from ``generator`` (on the params' device), lora_b zeros. Returns a new
    tree; the layers' other entries are shared."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        new_layer = dict(layer)
        for name, lin in layer.items():
            if name not in targets or not isinstance(lin, (DenseLinear, QuantizedLinear)):
                continue
            dev = lin.weight.device if isinstance(lin, DenseLinear) else lin.scales.device
            a = torch.randn((r, _true_in_features(lin)), generator=generator, device=dev,
                            dtype=dtype) / math.sqrt(r)
            b = torch.zeros((lin.out_features, r), dtype=dtype, device=dev)
            new_layer[name] = LoraLinear(base=lin, lora_a=a, lora_b=b, scale=alpha / r)
        layers.append(new_layer)
    out["layers"] = layers
    return out


def _holes(node):
    """The same tree with every tensor replaced by None."""
    return tree_map(lambda _: None, node)


def _split(node, adapters: bool):
    if isinstance(node, LoraLinear):
        if adapters:
            return dataclasses.replace(node, base=_holes(node.base))
        return dataclasses.replace(node, lora_a=None, lora_b=None)
    if isinstance(node, dict):
        return {k: _split(v, adapters) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_split(v, adapters) for v in node)
    return _holes(node) if adapters else node


def split_lora(params):
    """(adapters, frozen): only the lora_a/lora_b leaves train."""
    return _split(params, True), _split(params, False)


def _map_linears(fn, node):
    if isinstance(node, dict):
        return {k: _map_linears(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_linears(fn, v) for v in node)
    return fn(node)


def merge_lora(params: dict) -> dict:
    """Fold adapters into dense bases (W += scale B A, in f32); a quantized
    base cannot absorb a dense delta into its codes and stays wrapped
    (``apply_linear`` serves it with the adapters)."""

    def fold(x):
        if not isinstance(x, LoraLinear) or not isinstance(x.base, DenseLinear):
            return x
        delta = (x.lora_b.float() @ x.lora_a.float()) * x.scale
        w = x.base.weight
        return dataclasses.replace(x.base, weight=(w.float() + delta).to(w.dtype))

    return _map_linears(fold, params)


@dataclasses.dataclass
class LoraTrainState:
    adapters: Any
    frozen: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_lora_state(params: dict,
                    make_optimizer: Callable[[list], torch.optim.Optimizer]) -> LoraTrainState:
    """Split ``params``, copy the adapters as trainable leaves and build the
    optimizer over them (``make_optimizer(tensors)``, e.g.
    ``lambda p: torch.optim.Adam(p, lr=3e-3)``, the update of
    ``optax.adam(3e-3)``)."""
    adapters, frozen = split_lora(params)
    adapters = trainable_copy(adapters)
    return LoraTrainState(adapters=adapters, frozen=frozen,
                          optimizer=make_optimizer(tree_leaves(adapters)))


def make_lora_step(cfg, forward_fn=llama.forward):
    """The LM cross-entropy step over the adapters alone.

    ``step(state, input_ids [B, T], mask [B, T-1] or None) -> (state, loss)``
    runs the forward, the loss, ``backward()`` and the optimizer step (with
    autograd on; not under ``torch.inference_mode``), updating ``state`` in
    place; ``loss`` is the step's loss before the update, detached."""

    def step(state: LoraTrainState, input_ids: torch.Tensor, mask=None):
        with torch.enable_grad():
            params = merge_trainable(state.adapters, state.frozen)
            logits, _ = forward_fn(params, cfg, input_ids)
            loss = cross_entropy_loss(logits[:, :-1], input_ids[:, 1:], mask)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step
