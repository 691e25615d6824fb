"""AQLM weight representation and the dequantize-then-matmul path.

PyTorch counterpart of ``aqlm_tpu.ops.dequant``. ``dequantize_weight`` has
the JAX function's ``impl``: ``"xla"`` is the exact plain gather (the JAX
module's XLA path), ``"kernel"`` the Kx8 dequant kernel B13 with B14 as its
backward for the codebooks (``ops/kernels``; a CPU tensor runs their plain
versions), and ``"auto"`` picks the kernel for a CUDA tensor under the JAX
rule (out_group_size 1, at most 8 bits) and the plain gather otherwise.
Both are differentiable in the codebooks and the scales and compute the
same values. Schemes outside the rule (1x16, out groups > 1) keep the plain
gather on the card, as the JAX package keeps XLA for them.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.ops import kernels

__all__ = [
    "AqlmWeight",
    "broadcast_scales",
    "dequantize_weight",
    "aqlm_matmul_reference",
    "random_aqlm_weight",
]


@dataclasses.dataclass
class AqlmWeight:
    """One quantized linear weight.

    codes:     uint8/uint16 ``[num_out_groups, num_in_groups, num_codebooks]``
    codebooks: ``[num_codebooks, codebook_size, out_group_size, in_group_size]``
    scales:    ``[num_out_groups]`` or ``[num_out_groups, num_in_groups]``
    bias:      optional ``[out_features]``
    """

    codes: torch.Tensor
    codebooks: torch.Tensor
    scales: torch.Tensor
    bias: torch.Tensor | None
    scheme: AqlmScheme

    @property
    def out_features(self) -> int:
        return self.codes.shape[0] * self.scheme.out_group_size

    @property
    def in_features(self) -> int:
        return self.codes.shape[1] * self.scheme.in_group_size

    @property
    def shape(self) -> tuple[int, int]:
        return (self.out_features, self.in_features)


def broadcast_scales(scales: torch.Tensor, og: int, ig: int) -> torch.Tensor:
    """[OG] or [OG, IG] scales -> [OG, IG, 1, 1] broadcastable over groups."""
    if scales.ndim == 1:
        return scales.reshape(og, 1, 1, 1)
    return scales.reshape(og, ig, 1, 1)


def _dequant_groups(codes: torch.Tensor, cb: torch.Tensor, scheme: AqlmScheme) -> torch.Tensor:
    """Unscaled groups ``[OG, IG, o, i]``: the sum over codebooks of the
    selected codebook vectors (codes read unsigned)."""
    og, ig, k = codes.shape
    idx = codes.long()  # uint8/uint16 -> int64 keeps 8-bit codes unsigned
    groups = None
    for kk in range(k):
        part = cb[kk][idx[:, :, kk]]  # [OG, IG, o, i]
        groups = part if groups is None else groups + part
    return groups


class _DequantGroupsKernel(torch.autograd.Function):
    """Unscaled W [OUT, IN] f32 through B13 (precise f32 selection); the
    backward gives the codebooks their gradient through B14 (uint8 codes, so
    S <= 256, within ``CB_GRAD_MAX_SEGMENTS``); the codes get none."""

    @staticmethod
    def forward(ctx, codebooks, codes, num_segments):
        ctx.save_for_backward(codes)
        ctx.cb_dtype, ctx.num_segments = codebooks.dtype, num_segments
        return kernels.dequantize_groups(codes, codebooks[:, :, 0, :], precise=True)

    @staticmethod
    def backward(ctx, grad):
        (codes,) = ctx.saved_tensors
        og, ig, k = codes.shape
        data = grad.float().reshape(og * ig, -1)
        flat = codes.reshape(og * ig, k)
        dcb = kernels.cb_grad_segment(flat, data, ctx.num_segments)
        return dcb[:, :, None, :].to(ctx.cb_dtype), None, None


def _kernel_dequant_ok(w: AqlmWeight) -> bool:
    """The JAX rule for the kernel (out_group_size 1, at most 8 bits), on the card."""
    return (w.codes.device.type == "cuda" and w.scheme.out_group_size == 1
            and w.scheme.nbits_per_codebook <= 8)


def dequantize_weight(w: AqlmWeight, dtype=None, *, impl: str = "auto") -> torch.Tensor:
    """Dense weight ``[out_features, in_features]``:

    W[og*o, ig*i] = scales[og(, ig)] * sum_k codebooks[k, codes[og, ig, k], o, i]

    impl: ``"auto"`` (B13/B14 on the card under the JAX rule, the plain gather
    otherwise), ``"kernel"`` or ``"xla"`` (the plain gather) to force a path.
    """
    scheme = w.scheme
    og, ig, _ = w.codes.shape
    o, i = scheme.out_group_size, scheme.in_group_size
    if impl == "auto":
        impl = "kernel" if _kernel_dequant_ok(w) else "xla"
    if impl == "kernel":
        if o != 1:
            raise ValueError(f"the kernel dequant requires out_group_size == 1, got {scheme}")
        flat = _DequantGroupsKernel.apply(w.codebooks, w.codes, scheme.codebook_size)
        groups = flat.reshape(og, o, ig, i).permute(0, 2, 1, 3)
    elif impl == "xla":
        groups = _dequant_groups(w.codes, w.codebooks, scheme)
    else:
        raise ValueError(f"impl must be auto, kernel or xla, got {impl!r}")
    weight = groups * broadcast_scales(w.scales, og, ig).to(groups.dtype)
    weight = weight.permute(0, 2, 1, 3).reshape(og * o, ig * i)
    if dtype is not None:
        weight = weight.to(dtype)
    return weight


def aqlm_matmul_reference(x: torch.Tensor, w: AqlmWeight) -> torch.Tensor:
    """y = x @ W^T + b, the dequantize-then-matmul path (f32 accumulation)."""
    weight = dequantize_weight(w, dtype=x.dtype)
    y = torch.matmul(x.float(), weight.float().t()).to(x.dtype)
    if w.bias is not None:
        y = y + w.bias.to(y.dtype)
    return y


def random_aqlm_weight(
    generator: torch.Generator,
    scheme: AqlmScheme,
    out_features: int,
    in_features: int,
    dtype=torch.float32,
    with_bias: bool = False,
    device=None,
    weight_scale: float | None = None,
) -> AqlmWeight:
    """Random weight (codes uniform, codebooks normal, scales in [0.5, 1.5)).

    ``generator`` must live on ``device`` (``None`` means the card). A
    dequantized entry then has std ~``group_numel^-0.5 * (13/12)^0.5`` (0.368
    at g 8), whatever ``in_features``. ``weight_scale`` (None keeps that draw
    bit for bit) multiplies the scales after the same draw so that the
    entries' rms (their std: the mean is ~0) becomes ``weight_scale *
    in_features^-0.5``, a dense layer's."""
    dev = resolve_device(device)
    scheme.check_features(out_features, in_features)
    codes = torch.randint(
        0, scheme.codebook_size, scheme.codes_shape(out_features, in_features),
        generator=generator, device=dev, dtype=torch.int32,
    ).to(scheme.code_dtype)
    codebooks = (
        torch.randn(scheme.codebooks_shape(), generator=generator, device=dev)
        / (scheme.num_codebooks * scheme.group_numel) ** 0.5
    ).to(dtype)
    num_out_groups = out_features // scheme.out_group_size
    scales = torch.rand((num_out_groups,), generator=generator, device=dev) + 0.5
    if weight_scale is not None:
        # the rms of W's entries for uniform codes, from the drawn books and
        # scales: E[(sum_k C_k[c_k])^2] at each position of a group, averaged
        mean = codebooks.float().mean(dim=1)  # [K, og, ig]
        sq = (codebooks.float() ** 2).mean(dim=1).sum(dim=0) + mean.sum(dim=0) ** 2 \
            - (mean ** 2).sum(dim=0)
        rms = (sq.mean() * (scales ** 2).mean()) ** 0.5
        scales = scales * (weight_scale * in_features ** -0.5 / rms)
    scales = scales.to(dtype)
    bias = (
        torch.randn((out_features,), generator=generator, device=dev).to(dtype) * 0.01
        if with_bias
        else None
    )
    return AqlmWeight(codes=codes, codebooks=codebooks, scales=scales, bias=bias, scheme=scheme)
