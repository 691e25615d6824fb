"""Runtime weight formats and the quantized-matmul dispatcher.

PyTorch counterpart of ``aqlm_tpu.ops.runtime`` for the modes this port
covers:

- "codes" for Kx8 schemes (nbits <= 8) with out_group_size 1 and
  per-output scales: codes stay resident. At 128-aligned out_features they
  take the tiled layout, batch <= 8 runs the LUT-GEMV kernel (K1), larger
  batches the gather-dequant prefill kernel (K2); at any other out_features
  they keep the untiled ``codes_t`` layout and every batch runs the
  dequant-matmul kernel (B15, ``ops/kernels``);
- "int8" (W8A16): the dequantized weight re-quantized per output channel
  to int8 at load, [OUT, IN_pad] with ``aqlm_tpu``'s padding; every batch
  runs the int8 kernel (``ops/int8_matmul``);
- "int4" (W4A16): the dequantized weight re-quantized at load to 4 bits
  with one f32 scale per 128-column group (MSE-clipped), packed
  block-locally as ``aqlm_tpu`` packs it; every batch runs the int4 kernel
  (``ops/int4_matmul``);
- "reference": plain dequantize-then-matmul, the oracle.

Everything else raises ``NotImplementedError`` naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops.dequant import AqlmWeight, aqlm_matmul_reference, dequantize_weight
from aqlm_tpu_torch.ops.gather_prefill import (
    gather_prefill_matmul,
    gather_prefill_matmul_grouped_indexed,
    gather_prefill_matmul_indexed,
)
from aqlm_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_indexed, quantize_int4
from aqlm_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_indexed, quantize_int8
from aqlm_tpu_torch.ops.kernels import fused_onehot_matmul, fused_onehot_matmul_indexed
from aqlm_tpu_torch.ops.lut_gemv import (
    LUT_GEMV_MAX_BATCH,
    lut_gemv_kx8_grouped_indexed,
    lut_gemv_kx8_indexed,
    lut_gemv_kx8_tiled,
    proj_map_for,
    tile_codes,
)

__all__ = [
    "MODES",
    "QuantizedLinear",
    "IndexedQuantizedLinear",
    "FusedCodesLinear",
    "IndexedFusedCodesLinear",
    "quantized_matmul",
    "quantized_matmul_indexed",
    "fused_codes_matmul_indexed",
    "not_ported",
]

MODES = ("codes", "int8", "int4", "reference")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to aqlm_tpu_torch yet (ROADMAP {item})")


def _batch(x: torch.Tensor) -> int:
    n = 1
    for dim in x.shape[:-1]:
        n *= dim
    return n


@dataclasses.dataclass
class QuantizedLinear:
    """Device-ready quantized linear weight.

    reference mode: codes [OG, IG, K], codebooks [K, S, ogs, igs], scales.
    codes mode:     codes_tl [NT, K*IG, tn] uint8 (tiled) when OUT % 128
                    == 0, else codes_t [K, IG, OUT] uint8 (untiled);
                    codebooks [K, S, igs] bf16, scales [OUT] f32.
    int8 mode:      w8 [OUT, IN_pad] int8 (IN padded per
                    ``int8_matmul.pad_in_features``), w8_scale [OUT] f32,
                    scales ones.
    int4 mode:      w4 [OUT, IN_pad/2] uint8 (block-local nibbles, IN
                    padded per ``int4_matmul.pad_in_features_int4``),
                    w4_gscale [IN_pad/128, OUT] f32, scales ones.
    bias [OUT] or None. Stacked serving params carry a leading L axis.
    """

    codes: torch.Tensor | None
    codebooks: torch.Tensor | None
    scales: torch.Tensor
    bias: torch.Tensor | None
    scheme: AqlmScheme
    mode: str
    codes_tl: torch.Tensor | None = None
    w8: torch.Tensor | None = None
    w8_scale: torch.Tensor | None = None
    w4: torch.Tensor | None = None
    w4_gscale: torch.Tensor | None = None
    codes_t: torch.Tensor | None = None

    data_fields: ClassVar[tuple] = ("codes", "codebooks", "scales", "bias", "codes_tl", "w8",
                                    "w8_scale", "w4", "w4_gscale", "codes_t")

    @staticmethod
    def from_aqlm(w: AqlmWeight, mode: str = "codes") -> "QuantizedLinear":
        """Load-time transform of the canonical representation into a runtime layout."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        scheme = w.scheme
        scales = w.scales.float()
        if mode == "reference":
            return QuantizedLinear(codes=w.codes, codebooks=w.codebooks, scales=scales,
                                   bias=w.bias, scheme=scheme, mode=mode)
        if mode == "int8":
            w8, w8_scale = quantize_int8(dequantize_weight(w, dtype=torch.float32))
            return QuantizedLinear(codes=None, codebooks=None, scales=torch.ones_like(scales),
                                   bias=w.bias, scheme=scheme, mode=mode, w8=w8,
                                   w8_scale=w8_scale)
        if mode == "int4":
            dense = dequantize_weight(w, dtype=torch.float32)
            w4, w4_gscale = quantize_int4(dense)
            del dense  # the f32 dense and the clip search's candidates go before the next projection
            return QuantizedLinear(codes=None, codebooks=None, scales=torch.ones_like(scales),
                                   bias=w.bias, scheme=scheme, mode=mode, w4=w4,
                                   w4_gscale=w4_gscale)
        if scheme.out_group_size != 1:
            raise NotImplementedError("codes mode requires out_group_size == 1")
        if scales.ndim != 1:
            raise NotImplementedError(
                "codes mode applies scales in the per-out-channel epilogue; "
                "per-group scales (scale_nbits>0) need the reference mode"
            )
        if scheme.nbits_per_codebook > 8:
            raise not_ported("codes mode for 16-bit codebooks (1x16 gather)", "B1")
        codes_t = w.codes.permute(2, 1, 0).to(torch.uint8)  # [K, IG, OUT]
        cb = w.codebooks[:, :, 0, :].to(torch.bfloat16)
        if codes_t.shape[2] % 128:
            return QuantizedLinear(codes=None, codebooks=cb, scales=scales, bias=w.bias,
                                   scheme=scheme, mode=mode, codes_t=codes_t.contiguous())
        return QuantizedLinear(codes=None, codebooks=cb, scales=scales, bias=w.bias,
                               scheme=scheme, mode=mode, codes_tl=tile_codes(codes_t))


def quantized_matmul(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """y = x @ W_q^T + b through the runtime-mode kernel."""
    if q.mode == "reference":
        w = AqlmWeight(codes=q.codes, codebooks=q.codebooks, scales=q.scales,
                       bias=q.bias, scheme=q.scheme)
        return aqlm_matmul_reference(x, w)
    if q.mode == "int8":
        return int8_matmul(x, q.w8, q.w8_scale, q.bias)
    if q.mode == "int4":
        return int4_matmul(x, q.w4, q.w4_gscale, q.bias)
    g = q.scheme.in_group_size
    if q.codes_t is not None:
        return fused_onehot_matmul(x, q.codes_t, q.codebooks, q.scales, q.bias, group=g)
    if _batch(x) <= LUT_GEMV_MAX_BATCH:
        return lut_gemv_kx8_tiled(x, q.codes_tl, q.codebooks, q.scales, q.bias, group=g)
    return gather_prefill_matmul(x, q.codes_tl, q.codebooks, q.scales, q.bias, group=g)


@dataclasses.dataclass
class IndexedQuantizedLinear:
    """Layer ``idx`` of a stacked (leading L axis) QuantizedLinear: the kernels
    take the stacked arrays and a layer index, so nothing is copied."""

    stacked: QuantizedLinear
    idx: int


def _slice_layer(q: QuantizedLinear, idx: int) -> QuantizedLinear:
    pick = lambda a: None if a is None else a[idx]
    return QuantizedLinear(codes=pick(q.codes), codebooks=pick(q.codebooks),
                           scales=pick(q.scales), bias=pick(q.bias), scheme=q.scheme,
                           mode=q.mode, codes_tl=pick(q.codes_tl), w8=pick(q.w8),
                           w8_scale=pick(q.w8_scale), w4=pick(q.w4),
                           w4_gscale=pick(q.w4_gscale), codes_t=pick(q.codes_t))


def quantized_matmul_indexed(x: torch.Tensor, iq: IndexedQuantizedLinear) -> torch.Tensor:
    q = iq.stacked
    if q.mode == "reference":
        return quantized_matmul(x, _slice_layer(q, iq.idx))
    if q.mode == "int8":
        return int8_matmul_indexed(x, q.w8, q.w8_scale, iq.idx, q.bias)
    if q.mode == "int4":
        return int4_matmul_indexed(x, q.w4, q.w4_gscale, iq.idx, q.bias)
    g = q.scheme.in_group_size
    if q.codes_t is not None:
        return fused_onehot_matmul_indexed(x, q.codes_t, q.codebooks, q.scales, iq.idx, q.bias,
                                           group=g)
    if _batch(x) <= LUT_GEMV_MAX_BATCH:
        return lut_gemv_kx8_indexed(x, q.codes_tl, q.codebooks, q.scales, iq.idx, q.bias, group=g)
    return gather_prefill_matmul_indexed(x, q.codes_tl, q.codebooks, q.scales, iq.idx, q.bias,
                                         group=g)


@dataclasses.dataclass
class FusedCodesLinear:
    """Fused-projection codes-mode weight (q/k/v or gate/up).

    codes_tl [NT_total, K*IG, tn] concatenates the parts' tiles (a leading L
    axis once stacked); codebooks [P, K, S, g] per projection; scales
    [OUT_total]; proj_map int32 [NT_total] (derived: each tile's projection)."""

    codes_tl: torch.Tensor
    codebooks: torch.Tensor
    scales: torch.Tensor
    out_sizes: tuple
    scheme: AqlmScheme
    proj_map: torch.Tensor | None = None

    data_fields: ClassVar[tuple] = ("codes_tl", "codebooks", "scales")

    def __post_init__(self):
        if self.proj_map is None:
            self.proj_map = proj_map_for(self.out_sizes, self.codes_tl.shape[-1],
                                         self.codes_tl.device)


@dataclasses.dataclass
class IndexedFusedCodesLinear:
    """Layer ``idx`` of a stacked FusedCodesLinear."""

    stacked: FusedCodesLinear
    idx: int


def fused_codes_matmul_indexed(x: torch.Tensor, iq: IndexedFusedCodesLinear) -> torch.Tensor:
    f = iq.stacked
    g = f.scheme.in_group_size
    if _batch(x) <= LUT_GEMV_MAX_BATCH:
        return lut_gemv_kx8_grouped_indexed(x, f.codes_tl, f.codebooks, f.scales, f.out_sizes,
                                            iq.idx, group=g, proj_map=f.proj_map)
    return gather_prefill_matmul_grouped_indexed(x, f.codes_tl, f.codebooks, f.scales,
                                                 f.out_sizes, iq.idx, group=g,
                                                 proj_map=f.proj_map)
