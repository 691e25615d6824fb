"""Carry parameters flattened to numpy into the port's objects.

``params_from_numpy`` takes a nested structure of dicts, lists and numpy
arrays in which each weight object is a dict with a ``"__class__"`` key
(``"QuantizedLinear"``, ``"DenseLinear"``, ``"FusedCodesLinear"``,
``"StackedInt8Experts"`` or ``"StackedInt4Experts"``) and its fields, the
scheme given by name (``"2x8g8"``); a QuantizedLinear is in reference, codes (tiled or
untiled), int8 or int4 mode. A bf16 array arrives as its uint16 view wrapped in
``{"__bf16__": array}`` and becomes ``torch.bfloat16``. Codes copy across
as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.mixtral import StackedInt4Experts, StackedInt8Experts
from aqlm_tpu_torch.ops.runtime import FusedCodesLinear, QuantizedLinear, not_ported

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    if isinstance(a, dict):  # {"__bf16__": uint16 view}
        return torch.from_numpy(np.array(a["__bf16__"])).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(node, dev):
    if node is None or isinstance(node, (str, int, float, bool)):
        return node
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, dev) for v in node)
    if isinstance(node, dict) and "__bf16__" in node:
        return tensor_from_numpy(node, dev)
    if isinstance(node, dict) and "__class__" in node:
        kind = node["__class__"]
        t = lambda k: None if node.get(k) is None else tensor_from_numpy(node[k], dev)
        if kind == "DenseLinear":
            return DenseLinear(weight=t("weight"), bias=t("bias"))
        if kind == "StackedInt8Experts":
            return StackedInt8Experts(w8=t("w8"), scale=t("scale"))
        if kind == "StackedInt4Experts":
            return StackedInt4Experts(w4=t("w4"), gscale=t("gscale"))
        scheme = AqlmScheme.parse(node["scheme"])
        if kind == "FusedCodesLinear":
            return FusedCodesLinear(codes_tl=t("codes_tl"), codebooks=t("codebooks"),
                                    scales=t("scales"), out_sizes=tuple(node["out_sizes"]),
                                    scheme=scheme)
        if kind != "QuantizedLinear":
            raise TypeError(f"unknown weight class {kind!r}")
        mode = node["mode"]
        if mode == "reference":
            return QuantizedLinear(codes=t("codes"), codebooks=t("codebooks"), scales=t("scales"),
                                   bias=t("bias"), scheme=scheme, mode=mode)
        if mode == "int8":
            return QuantizedLinear(codes=None, codebooks=None, scales=t("scales"), bias=t("bias"),
                                   scheme=scheme, mode=mode, w8=t("w8"), w8_scale=t("w8_scale"))
        if mode == "int4":
            return QuantizedLinear(codes=None, codebooks=None, scales=t("scales"), bias=t("bias"),
                                   scheme=scheme, mode=mode, w4=t("w4"), w4_gscale=t("w4_gscale"))
        if mode != "codes":
            raise ValueError(f"unknown QuantizedLinear mode {mode!r}")
        if node.get("codes_tl") is None and node.get("codes_t") is None:
            raise not_ported("codes mode for 16-bit codebooks (1x16 gather)", "B1")
        return QuantizedLinear(codes=None, codebooks=t("codebooks"), scales=t("scales"),
                               bias=t("bias"), scheme=scheme, mode=mode, codes_tl=t("codes_tl"),
                               codes_t=t("codes_t"))
    if isinstance(node, dict):
        return {k: _convert(v, dev) for k, v in node.items()}
    return tensor_from_numpy(node, dev)


def params_from_numpy(tree, device=None):
    """The port's parameter objects on ``device`` (None = the card)."""
    return _convert(tree, resolve_device(device))
