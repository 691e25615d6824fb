"""Shared model components: linear wrapper, RMSNorm, RoPE, GQA attention.

PyTorch counterpart of ``aqlm_tpu.models.common``. Plain functions on
tensors; layouts follow the JAX package so the two compare like with like.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from aqlm_tpu_torch.ops.runtime import (
    IndexedFusedCodesLinear,
    IndexedQuantizedLinear,
    QuantizedLinear,
    fused_codes_matmul_indexed,
    quantized_matmul,
    quantized_matmul_indexed,
)

__all__ = [
    "DenseLinear",
    "LoraLinear",
    "apply_linear",
    "rms_norm",
    "rope_inv_freq",
    "rope",
    "make_causal_mask",
    "attention",
    "attention_headmajor",
]


@dataclasses.dataclass
class DenseLinear:
    """Unquantized linear: weight [OUT, IN], optional bias."""

    weight: torch.Tensor
    bias: torch.Tensor | None

    data_fields: ClassVar[tuple] = ("weight", "bias")

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]


@dataclasses.dataclass
class LoraLinear:
    """Low-rank adapter on a frozen base linear: y = base(x) + scale (x A^T) B^T.

    The PEFT recipe of AQLM's 2-bit training: adapters train through the
    serving matmul's activation backward while the codes, codebooks and
    scales stay frozen. lora_a [r, IN], lora_b [OUT, r] (zeros at the start,
    so the wrapped model starts equal to its base); scale = alpha / r."""

    base: object  # DenseLinear | QuantizedLinear
    lora_a: torch.Tensor
    lora_b: torch.Tensor
    scale: float

    data_fields: ClassVar[tuple] = ("base", "lora_a", "lora_b")

    @property
    def out_features(self) -> int:
        return self.lora_b.shape[0]


def apply_linear(x: torch.Tensor, lin) -> torch.Tensor:
    """x [..., IN] @ W^T for a DenseLinear, QuantizedLinear, LoraLinear,
    indexed view, or a weightless linear with an ``apply(x)``."""
    if isinstance(lin, LoraLinear):
        # adapters in x's dtype; the scale rounds to y's dtype, and so does the
        # delta before the add
        y = apply_linear(x, lin.base)
        delta = torch.matmul(torch.matmul(x, lin.lora_a.to(x.dtype).t()), lin.lora_b.to(x.dtype).t())
        scale = float(torch.tensor(lin.scale, dtype=y.dtype))
        return y + delta.to(y.dtype) * scale
    if isinstance(lin, IndexedQuantizedLinear):
        return quantized_matmul_indexed(x, lin)
    if isinstance(lin, IndexedFusedCodesLinear):
        return fused_codes_matmul_indexed(x, lin)
    if isinstance(lin, QuantizedLinear):
        return quantized_matmul(x, lin)
    if callable(getattr(lin, "apply", None)) and not hasattr(lin, "weight"):
        # a weightless functional linear (the scanned PV student's projections)
        return lin.apply(x)
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32; gemma uses (1 + w) via plus_one."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def rope_inv_freq(d: int, theta: float, scaling=None, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies, with optional HF rope_scaling
    (("linear", factor) or ("llama3", factor, low_freq_factor,
    high_freq_factor, original_max_pos))."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    if scaling is None:
        return inv_freq
    kind = scaling[0]
    if kind == "linear":
        return inv_freq / scaling[1]
    if kind == "llama3":
        _, factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        return torch.where(
            wavelen > orig / low_f, inv_freq / factor,
            torch.where(wavelen < orig / high_f, inv_freq, smoothed),
        )
    raise ValueError(f"unknown rope scaling {kind!r}")


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         scaling=None):
    """Rotary embeddings, HF 'half-split' layout. q, k: [B, T, H, D]."""
    d = q.shape[-1]
    inv_freq = rope_inv_freq(d, theta, scaling, device=q.device)
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


def make_causal_mask(q_positions: torch.Tensor, k_positions: torch.Tensor,
                     window: int | None = None) -> torch.Tensor:
    """[B, 1, Tq, Tk] bool: a query sees keys with pos <= its own; with
    ``window``, only keys in (q - window, q]."""
    mask = k_positions[:, None, None, :] <= q_positions[:, None, :, None]
    if window is not None:
        mask = mask & (k_positions[:, None, None, :] > q_positions[:, None, :, None] - window)
    return mask


def _softmax_attend(qs, k, v, mask, k_spec, out_dtype):
    """Shared body: qs [B, Tq, Hkv, rep, D] pre-scaled; k/v in layout k_spec."""
    logits = torch.einsum(f"bqhrd,{k_spec}->bhrqk", qs.float(), k.float())
    logits = torch.where(mask[:, :, None, :, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = probs.to(v.dtype).float()
    return torch.einsum(f"bhrqk,{k_spec}->bqhrd", probs, v.float()).to(out_dtype)


def attention(q, k, v, mask, *, scale: float | None = None):
    """GQA attention. q [B, Tq, Hq, D]; k/v [B, Tk, Hkv, D]; mask [B, 1, Tq, Tk]."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qs = (q.float() * scale).to(q.dtype).reshape(b, tq, hkv, hq // hkv, d)
    out = _softmax_attend(qs, k, v, mask, "bkhd", q.dtype)
    return out.reshape(b, tq, hq, d)


def attention_headmajor(q, k_hm, v_hm, mask, *, scale: float | None = None):
    """GQA attention over a head-major cache: q [B, Tq, Hq, D]; k_hm/v_hm
    [B, Hkv, S, D]; mask [B, 1, Tq, S]."""
    b, tq, hq, d = q.shape
    hkv = k_hm.shape[1]
    if scale is None:
        scale = d ** -0.5
    qs = (q.float() * scale).to(q.dtype).reshape(b, tq, hkv, hq // hkv, d)
    out = _softmax_attend(qs, k_hm, v_hm, mask, "bhkd", q.dtype)
    return out.reshape(b, tq, hq, d)
