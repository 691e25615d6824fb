"""The trainable/frozen split of a parameter tree (PyTorch counterpart of
``aqlm_tpu.pv.trainer.split_trainable`` / ``merge_trainable``).

A tree is dicts, lists, weight dataclasses (``QuantizedLinear``,
``DenseLinear``, ``LoraLinear`` around its base: their ``data_fields``) and
tensors. Float tensors train; integer tensors (the
codes) freeze. The split gives two trees of the same shape with ``None``
holes; ``merge_trainable`` fills each hole from the other tree.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["split_trainable", "merge_trainable", "tree_map", "tree_leaves"]


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
