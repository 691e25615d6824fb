"""Training-state checkpoints (PyTorch counterpart of
``aqlm_tpu.io.train_state``): a whole ``PVState`` / ``TrainState`` in one
.npz, restored into a state built by the same init code.

A tree is tensors, dicts, lists, weight and state dataclasses (their
``data_fields``) and ``torch.optim.Optimizer`` objects, whose
``state_dict()`` tensors are leaves too (scalars go to the file's metadata).
Leaves are saved in the tree's order under ``leaf_{i}`` with the
checkpoint module's ``_savez`` (bf16 kept). Restoring copies each leaf into
the template's tensor where an optimizer holds that tensor (so the optimizer
keeps its params), replaces every other leaf, and loads each optimizer's
state dict. The file is the port's own: ``aqlm_tpu`` does not read it, as
optax lays its optimizer state out otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from aqlm_tpu_torch.io.checkpoint import _loadz, _savez

__all__ = ["save_pytree", "load_pytree"]


def _children(node):
    """(kind, items) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return "dict", list(node.items())
    if isinstance(node, (list, tuple)):
        return "seq", list(enumerate(node))
    if dataclasses.is_dataclass(node) and hasattr(node, "data_fields"):
        return "dc", [(n, getattr(node, n)) for n in node.data_fields]
    return None


def _opt_entries(opt: torch.optim.Optimizer):
    """(param index, key, value) of an optimizer's state, in a fixed order."""
    state = opt.state_dict()["state"]
    return [(pid, k, v) for pid in sorted(state) for k, v in state[pid].items()]


def save_pytree(path: str, tree, metadata: dict | None = None) -> str:
    arrays, opts = {}, []

    def walk(node):
        if isinstance(node, torch.Tensor):
            arrays[f"leaf_{len(arrays)}"] = node.detach()
        elif isinstance(node, torch.optim.Optimizer):
            entries = []
            for pid, k, v in _opt_entries(node):
                if isinstance(v, torch.Tensor):
                    entries.append([pid, k, len(arrays)])
                    arrays[f"leaf_{len(arrays)}"] = v.detach()
                else:
                    entries.append([pid, k, None, v])
            opts.append(entries)
        elif (kids := _children(node)) is not None:
            for _, v in kids[1]:
                walk(v)

    walk(tree)
    n = len(arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays["__meta__"] = np.asarray(json.dumps(
        {"num_leaves": n, "metadata": metadata or {}, "optimizers": opts}))
    _savez(path, arrays)
    return path


def load_pytree(path: str, template):
    """Restore a file of ``save_pytree`` into ``template``'s structure (the
    same init code's state). Returns (tree, metadata)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = _loadz(path)
    meta = json.loads(str(data["__meta__"]))
    opts = iter(meta["optimizers"])
    held = set()

    def collect(node):
        if isinstance(node, torch.optim.Optimizer):
            held.update(id(p) for g in node.param_groups for p in g["params"])
        elif (kids := _children(node)) is not None:
            for _, v in kids[1]:
                collect(v)

    collect(template)
    pos = [0]  # the next leaf index

    def leaf(like: torch.Tensor | None = None):
        key = f"leaf_{pos[0]}"
        if key not in data:
            raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the template more")
        pos[0] += 1
        arr = data[key]
        if like is not None and tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf shape mismatch: {tuple(arr.shape)} vs {tuple(like.shape)}")
        return arr

    def walk(node):
        if isinstance(node, torch.Tensor):
            arr = leaf(node)
            if id(node) in held:
                with torch.no_grad():
                    node.copy_(arr)
                return node
            return arr.to(device=node.device, dtype=node.dtype)
        if isinstance(node, torch.optim.Optimizer):
            state = {}
            for pid, k, idx, *scalar in next(opts):
                state.setdefault(pid, {})[k] = scalar[0] if idx is None else leaf()
            node.load_state_dict({"state": state,
                                  "param_groups": node.state_dict()["param_groups"]})
            return node
        kids = _children(node)
        if kids is None:
            return node
        kind, items = kids
        new = {k: walk(v) for k, v in items}
        if kind == "dict":
            return new
        if kind == "seq":
            return type(node)(new[i] for i in range(len(items)))
        return dataclasses.replace(node, **new)

    out = walk(template)
    if pos[0] != meta["num_leaves"]:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the template {pos[0]}")
    return out, meta["metadata"]
