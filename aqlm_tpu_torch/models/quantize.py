"""Model-level quantization plumbing (PyTorch counterpart of
``aqlm_tpu.models.quantize``): random quantized models for tests and the
chip smoke run, the transcode of a calibrated (reference-mode) model to a
runtime mode, and per-projection edits (``map_quantized_linears``,
``swap_in_quantized``). Embeddings, lm_head and a Mixtral router stay
dense."""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.family import family_module
from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS, ModelConfig
from aqlm_tpu_torch.ops.dequant import AqlmWeight, random_aqlm_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

__all__ = ["random_quantized_params", "random_quantize_projections", "convert_runtime_mode",
           "map_quantized_linears", "swap_in_quantized"]


def convert_runtime_mode(params: dict, mode: str) -> dict:
    """Transcode every QuantizedLinear of the layers (any name, a Mixtral's
    experts included) from the canonical reference layout to ``mode``, in
    place; returns ``params``. A materialized runtime layout cannot be
    transcoded again and raises."""
    if mode == "reference":
        return params
    for layer in params["layers"]:
        for name, lin in list(layer.items()):
            if not isinstance(lin, QuantizedLinear) or lin.mode == mode:
                continue
            if lin.mode != "reference":
                raise ValueError(f"cannot transcode a materialized {lin.mode!r} layout to "
                                 f"{mode!r}; reconvert from the canonical checkpoint")
            w = AqlmWeight(codes=lin.codes, codebooks=lin.codebooks, scales=lin.scales,
                           bias=lin.bias, scheme=lin.scheme)
            layer[name] = QuantizedLinear.from_aqlm(w, mode=mode)
    return params


def random_quantized_params(generator: torch.Generator, cfg: ModelConfig, scheme: AqlmScheme,
                            mode: str = "codes", dtype=torch.bfloat16, device=None,
                            weight_scale: float | None = None) -> dict:
    """Random model (Llama, Mixtral or Falcon) whose projections are
    QuantizedLinear in ``mode``.

    Built directly on ``device`` (None = the card) from ``generator``, which
    must live there; no dense copy of a quantized projection is made.
    Projections whose shape the scheme cannot tile stay dense.

    ``weight_scale`` None (the default) is the plain draw, whose quantized
    projections have entries of std ~0.37 at any width: at Llama-2-7B's the
    attention is then nearly an argmax and kernels that round differently
    pick other keys. A given ``weight_scale`` draws the same numbers and
    scales each projection (dense ones too) to std ``weight_scale *
    in_features^-0.5``."""
    dev = resolve_device(device)
    module = family_module(cfg)
    params = module.init_random_params(generator, cfg, dtype=dtype, device=dev, dense_projs=False)
    shapes = module.projection_shapes(cfg)
    for layer in params["layers"]:
        for name, (out_f, in_f) in shapes.items():
            if out_f % scheme.out_group_size or in_f % scheme.in_group_size:
                w = torch.randn((out_f, in_f), generator=generator, device=dev) * in_f ** -0.5
                if weight_scale is not None:
                    w = w * weight_scale
                layer[name] = DenseLinear(weight=w.to(dtype), bias=None)
                continue
            w = random_aqlm_weight(generator, scheme, out_f, in_f, dtype=torch.float32, device=dev,
                                   weight_scale=weight_scale)
            layer[name] = QuantizedLinear.from_aqlm(w, mode=mode)
    return params


def map_quantized_linears(params: dict, fn) -> dict:
    """Replace every QuantizedLinear among the layers' Llama projections
    with ``fn(layer_idx, name, qlin)``, in place; returns ``params``."""
    for li, layer in enumerate(params["layers"]):
        for name in QUANTIZABLE_PROJS:
            if isinstance(layer.get(name), QuantizedLinear):
                layer[name] = fn(li, name, layer[name])
    return params


def swap_in_quantized(params: dict, layer_idx: int, name: str, w: AqlmWeight, mode: str) -> dict:
    """Replace one projection with ``QuantizedLinear.from_aqlm(w, mode)``."""
    params["layers"][layer_idx][name] = QuantizedLinear.from_aqlm(w, mode=mode)
    return params


def random_quantize_projections(generator: torch.Generator, params: dict, scheme: AqlmScheme,
                                mode: str = "reference", skip=("moe_gate",)) -> dict:
    """Swap every quantizable 2-D DenseLinear of the layer dicts (a Mixtral's
    ``experts.{e}.*`` included; the router and names in ``skip`` excluded)
    for a random-codes QuantizedLinear in ``mode``, keeping its bias. In
    place; returns ``params``. ``generator`` lives on the params' device."""
    for layer in params["layers"]:
        for name, lin in list(layer.items()):
            if name in skip or not isinstance(lin, DenseLinear) or lin.weight.ndim != 2:
                continue
            out_f, in_f = lin.weight.shape
            if out_f % scheme.out_group_size or in_f % scheme.in_group_size:
                continue
            w = random_aqlm_weight(generator, scheme, out_f, in_f, dtype=torch.float32,
                                   device=lin.weight.device)
            if lin.bias is not None:
                w = dataclasses.replace(w, bias=lin.bias)
            layer[name] = QuantizedLinear.from_aqlm(w, mode=mode)
    return params
