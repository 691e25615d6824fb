"""Falcon-style causal LM (PyTorch counterpart of ``aqlm_tpu.models.falcon``).

What differs from the Llama block:

- a PARALLEL block: one input LayerNorm feeds both attention and the MLP,
  and both residual-add into the block input;
- LayerNorm with bias (f32 statistics, biased variance), not RMSNorm;
- multi-query attention (Falcon-7B: 71 query heads over 1 kv head), the
  shared GQA attention with ``num_kv_heads=1``;
- a GELU MLP (fc1 -> gelu -> fc2), GELU in its tanh approximation, the
  default of ``jax.nn.gelu``.

Params are a plain dict like the Llama family's, with ``input_norm_bias`` per
layer, ``final_norm_bias``, and ``fc1``/``fc2`` in place of gate/up/down.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import apply_linear, attention, make_causal_mask, rope
from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["FalconConfig", "layer_norm", "gelu", "init_random_params", "projection_shapes",
           "forward", "block_forward_with_taps"]


@dataclasses.dataclass(frozen=True)
class FalconConfig(llama.ModelConfig):
    ln_eps: float = 1e-5

    @classmethod
    def falcon_7b(cls) -> "FalconConfig":
        return cls(vocab_size=65024, hidden_size=4544, intermediate_size=4 * 4544, num_layers=32,
                   num_heads=71, num_kv_heads=1, max_position_embeddings=2048,
                   rope_theta=10000.0)

    @classmethod
    def tiny(cls, **kw) -> "FalconConfig":
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=1, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with bias, statistics in f32 (biased variance)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def gelu(h: torch.Tensor, dtype) -> torch.Tensor:
    """GELU (tanh approximation) of fc1's output on its f32 upcast, cast to ``dtype``."""
    return F.gelu(h.float(), approximate="tanh").to(dtype)


def projection_shapes(cfg: FalconConfig) -> dict:
    """(out_features, in_features) of each quantizable projection."""
    h, d = cfg.hidden_size, cfg.dim_per_head
    return dict(
        q_proj=(cfg.num_heads * d, h), k_proj=(cfg.num_kv_heads * d, h),
        v_proj=(cfg.num_kv_heads * d, h), o_proj=(h, cfg.num_heads * d),
        fc1=(cfg.intermediate_size, h), fc2=(h, cfg.intermediate_size),
    )


def init_random_params(generator: torch.Generator, cfg: FalconConfig, dtype=torch.bfloat16,
                       device=None, *, dense_projs: bool = True) -> dict:
    """Random dense params. ``generator`` lives on ``device`` (None = the
    card). ``dense_projs=False`` leaves the projections out (callers that
    quantize every projection skip the dense weights)."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        layer = dict(input_norm=torch.ones((h,), dtype=dtype, device=dev),
                     input_norm_bias=torch.zeros((h,), dtype=dtype, device=dev))
        if dense_projs:
            for name, (o, i) in projection_shapes(cfg).items():
                layer[name] = llama._dense(generator, o, i, dtype, dev)
        layers.append(layer)
    embed = torch.randn((cfg.vocab_size, h), generator=generator, device=dev) * 0.02
    return dict(
        embed=embed.to(dtype),
        layers=layers,
        final_norm=torch.ones((h,), dtype=dtype, device=dev),
        final_norm_bias=torch.zeros((h,), dtype=dtype, device=dev),
        lm_head=llama._dense(generator, cfg.vocab_size, h, dtype, dev),
    )


def _block(x, layer, cfg: FalconConfig, positions):
    b, t, _ = x.shape
    d = cfg.dim_per_head
    xn = layer_norm(x, layer["input_norm"], layer["input_norm_bias"], cfg.ln_eps)
    q = apply_linear(xn, layer["q_proj"]).reshape(b, t, cfg.num_heads, d)
    k = apply_linear(xn, layer["k_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    v = apply_linear(xn, layer["v_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    q, k = rope(q, k, positions, cfg.rope_theta)
    attn = attention(q, k, v, make_causal_mask(positions, positions)).reshape(b, t, -1)
    attn_out = apply_linear(attn, layer["o_proj"])
    mlp = apply_linear(gelu(apply_linear(xn, layer["fc1"]), x.dtype), layer["fc2"])
    # parallel residual: both branches add into the SAME input
    return x + attn_out + mlp


def block_forward_with_taps(x, layer, cfg: FalconConfig, positions):
    raise not_ported("Falcon calibration taps", "A12")


def forward(params: dict, cfg: FalconConfig, input_ids: torch.Tensor, *,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal LM forward over the list of layers, without a KV cache (the
    serving form with a cache is ``models.stacked.forward_stacked``).
    Returns logits [B, T, V]."""
    b, t = input_ids.shape
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)[None, :]
    positions = positions.expand(b, t)
    x = params["embed"][input_ids]
    for layer in params["layers"]:
        x = _block(x, layer, cfg, positions)
    x = layer_norm(x, params["final_norm"], params["final_norm_bias"], cfg.ln_eps)
    return llama.head(x, params, cfg)
