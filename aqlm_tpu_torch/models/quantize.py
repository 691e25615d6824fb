"""Model-level quantization plumbing (PyTorch counterpart of
``aqlm_tpu.models.quantize``): random quantized models for tests and the
chip smoke run. Embeddings, lm_head and a Mixtral router stay dense."""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.family import family_module
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.ops.dequant import random_aqlm_weight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

__all__ = ["random_quantized_params", "random_quantize_projections"]


def random_quantized_params(generator: torch.Generator, cfg: ModelConfig, scheme: AqlmScheme,
                            mode: str = "codes", dtype=torch.bfloat16, device=None) -> dict:
    """Random model (Llama, Mixtral or Falcon) whose projections are
    QuantizedLinear in ``mode``.

    Built directly on ``device`` (None = the card) from ``generator``, which
    must live there; no dense copy of a quantized projection is made.
    Projections whose shape the scheme cannot tile stay dense."""
    dev = resolve_device(device)
    module = family_module(cfg)
    params = module.init_random_params(generator, cfg, dtype=dtype, device=dev, dense_projs=False)
    shapes = module.projection_shapes(cfg)
    for layer in params["layers"]:
        for name, (out_f, in_f) in shapes.items():
            if out_f % scheme.out_group_size or in_f % scheme.in_group_size:
                w = torch.randn((out_f, in_f), generator=generator, device=dev) * in_f ** -0.5
                layer[name] = DenseLinear(weight=w.to(dtype), bias=None)
                continue
            w = random_aqlm_weight(generator, scheme, out_f, in_f, dtype=torch.float32, device=dev)
            layer[name] = QuantizedLinear.from_aqlm(w, mode=mode)
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
