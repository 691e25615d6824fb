"""Load-time projection fusion and the int8 lm_head for serving (PyTorch
counterpart of ``aqlm_tpu.serve.fuse``, tp=1).

q/k/v and gate/up share their input, so their weights concatenate along OUT
and each group runs as ONE kernel launch (7 -> 4 per block): int8 linears
concatenate their ``w8`` rows and int4 linears their ``w4`` rows and
group-scale columns (``fuse_projections``), tiled codes linears their code
tiles (``fuse_projections_codes``). ``quantize_lm_head_int8``
turns the output head, the largest weight read per decode step, into an
int8 linear. The tensor-parallel interleaved layout is ROADMAP A14.
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.ops.int4_matmul import quantize_int4
from aqlm_tpu_torch.ops.int8_matmul import quantize_int8
from aqlm_tpu_torch.ops.runtime import FusedCodesLinear, QuantizedLinear, not_ported

__all__ = ["fuse_projections", "fuse_projections_codes", "int4_linear_from_dense",
           "int8_linear_from_dense", "quantize_lm_head_int8"]

_GROUPS = (("qkv_proj", ("q_proj", "k_proj", "v_proj")), ("gateup_proj", ("gate_proj", "up_proj")))


def _fuse_groups(params: dict, concat, donate: bool) -> dict:
    """Replace each group of ``_GROUPS`` by its fused linear where ``concat``
    returns one (None leaves the group as it is). Returns a new params dict;
    ``donate=True`` edits the layer dicts in place, so each group's parts
    are freed as its fused copy appears. Other keys (a Mixtral's
    ``experts.*``) stay as they are."""
    new_layers = []
    for orig in params["layers"]:
        layer = orig if donate else dict(orig)
        for fused, names in _GROUPS:
            f = concat([layer.get(n) for n in names])
            if f is None:
                continue
            layer[fused] = f
            for n in names:
                del layer[n]
        new_layers.append(layer)
    return {**params, "layers": new_layers}


def _concat_int8(lins: list[QuantizedLinear]) -> QuantizedLinear:
    """Concatenate int8 linears along OUT; a missing bias becomes zeros."""
    bias = None
    if any(l.bias is not None for l in lins):
        bias = torch.cat([l.bias if l.bias is not None
                          else torch.zeros((l.w8.shape[0],), dtype=torch.float32, device=l.w8.device)
                          for l in lins])
    w8 = torch.cat([l.w8 for l in lins])
    return QuantizedLinear(codes=None, codebooks=None,
                           scales=torch.ones((w8.shape[0],), dtype=torch.float32, device=w8.device),
                           bias=bias, scheme=lins[0].scheme, mode="int8", w8=w8,
                           w8_scale=torch.cat([l.w8_scale for l in lins]))


def _concat_int4(lins: list[QuantizedLinear]) -> QuantizedLinear:
    """Concatenate bias-free int4 linears along OUT: ``w4`` rows, and the
    ``[IN_pad/128, OUT]`` group scales along their OUT axis (axis 1)."""
    w4 = torch.cat([l.w4 for l in lins])
    return QuantizedLinear(codes=None, codebooks=None,
                           scales=torch.ones((w4.shape[0],), dtype=torch.float32, device=w4.device),
                           bias=None, scheme=lins[0].scheme, mode="int4", w4=w4,
                           w4_gscale=torch.cat([l.w4_gscale for l in lins], dim=1))


def fuse_projections(params: dict, cfg: ModelConfig, donate: bool = False, tp: int = 1) -> dict:
    """Replace q/k/v -> qkv_proj and gate/up -> gateup_proj where all parts
    are int8-mode QuantizedLinear, or int4-mode ones without a bias (an int4
    group with a bias stays unfused, as in ``aqlm_tpu``). Returns a new
    params dict; ``donate=True`` drops the parts from the caller's layer
    dicts as each fused copy materializes."""
    if tp != 1:
        raise not_ported("the tensor-parallel fused layout", "A14")

    def fusible(lins, mode):
        return all(isinstance(l, QuantizedLinear) and l.mode == mode for l in lins)

    def concat(lins):
        if fusible(lins, "int8"):
            return _concat_int8(lins)
        if fusible(lins, "int4") and all(l.bias is None for l in lins):
            return _concat_int4(lins)
        return None

    return _fuse_groups(params, concat, donate)


def int8_linear_from_dense(weight: torch.Tensor, bias=None) -> QuantizedLinear:
    """Per-out-channel int8 quantization of a dense [OUT, IN] weight, in the
    runtime container the AQLM int8 mode uses."""
    w8, w8_scale = quantize_int8(weight.float())
    return QuantizedLinear(codes=None, codebooks=None,
                           scales=torch.ones((w8.shape[0],), dtype=torch.float32, device=w8.device),
                           bias=None if bias is None else bias.float(), scheme=AqlmScheme(),
                           mode="int8", w8=w8, w8_scale=w8_scale)


def int4_linear_from_dense(weight: torch.Tensor, bias=None) -> QuantizedLinear:
    """Per-group int4 quantization of a dense [OUT, IN] weight, in the
    runtime container the AQLM int4 mode uses."""
    w4, w4_gscale = quantize_int4(weight.float())
    return QuantizedLinear(codes=None, codebooks=None,
                           scales=torch.ones((w4.shape[0],), dtype=torch.float32, device=w4.device),
                           bias=None if bias is None else bias.float(), scheme=AqlmScheme(),
                           mode="int4", w4=w4, w4_gscale=w4_gscale)


def quantize_lm_head_int8(params: dict) -> dict:
    """int8-quantize the lm_head (or materialize one from tied embeddings)."""
    head = params.get("lm_head")
    if head is not None:
        return {**params, "lm_head": int8_linear_from_dense(head.weight, head.bias)}
    return {**params, "lm_head": int8_linear_from_dense(params["embed"])}


def _concat_codes(lins: list[QuantizedLinear]) -> FusedCodesLinear:
    """Concatenate tiled-codes linears along the tile axis (== along OUT)."""
    return FusedCodesLinear(
        codes_tl=torch.cat([l.codes_tl for l in lins], dim=0),
        codebooks=torch.stack([l.codebooks for l in lins]),
        scales=torch.cat([l.scales for l in lins]),
        out_sizes=tuple(l.codes_tl.shape[0] * l.codes_tl.shape[2] for l in lins),
        scheme=lins[0].scheme,
    )


def _codes_fusible(lins) -> bool:
    return (
        all(
            isinstance(l, QuantizedLinear) and l.mode == "codes"
            and l.codes_tl is not None and l.bias is None
            for l in lins
        )
        and len({l.scheme for l in lins}) == 1
        and len({tuple(l.codes_tl.shape[1:]) for l in lins}) == 1  # same K*IG and tn
    )


def fuse_projections_codes(params: dict, cfg: ModelConfig, donate: bool = False) -> dict:
    """Replace q/k/v -> qkv_proj and gate/up -> gateup_proj where all parts
    are tiled codes-mode QuantizedLinear. Returns a new params dict
    (``donate`` as in ``fuse_projections``)."""
    return _fuse_groups(params, lambda lins: _concat_codes(lins) if _codes_fusible(lins) else None,
                        donate)
