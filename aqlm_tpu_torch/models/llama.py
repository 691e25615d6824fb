"""Llama-family causal LM (PyTorch counterpart of ``aqlm_tpu.models.llama``).

Parameters are a plain dict: every projection is a DenseLinear or a
QuantizedLinear. ``forward`` is the unstacked (list-of-layers) forward; the
serving form is ``models.stacked.forward_stacked``.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import (
    DenseLinear,
    apply_linear,
    attention,
    make_causal_mask,
    rms_norm,
    rope,
)

__all__ = ["ModelConfig", "init_random_params", "forward", "QUANTIZABLE_PROJS", "projection_shapes"]

QUANTIZABLE_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_bias: bool = False
    gemma_norm: bool = False
    logit_softcap: float | None = None
    max_position_embeddings: int = 4096
    sliding_window: int | None = None
    rope_scaling: tuple | None = None

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
                   num_heads=32, num_kv_heads=8, rope_theta=500000.0,
                   max_position_embeddings=8192)

    @classmethod
    def llama2_70b(cls) -> "ModelConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80, num_heads=64,
                   num_kv_heads=8)

    @classmethod
    def llama3_70b(cls) -> "ModelConfig":
        return cls(vocab_size=128256, hidden_size=8192, intermediate_size=28672, num_layers=80,
                   num_heads=64, num_kv_heads=8, rope_theta=500000.0,
                   max_position_embeddings=8192)

    @classmethod
    def llama3_1_8b(cls) -> "ModelConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
                   num_heads=32, num_kv_heads=8, rope_theta=500000.0,
                   max_position_embeddings=131072,
                   rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))

    @classmethod
    def mistral_7b(cls) -> "ModelConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
                   num_heads=32, num_kv_heads=8, rope_theta=10000.0,
                   max_position_embeddings=8192, sliding_window=4096)


def projection_shapes(cfg: ModelConfig) -> dict:
    """(out_features, in_features) of each quantizable projection."""
    h, d = cfg.hidden_size, cfg.dim_per_head
    return dict(
        q_proj=(cfg.num_heads * d, h), k_proj=(cfg.num_kv_heads * d, h),
        v_proj=(cfg.num_kv_heads * d, h), o_proj=(h, cfg.num_heads * d),
        gate_proj=(cfg.intermediate_size, h), up_proj=(cfg.intermediate_size, h),
        down_proj=(h, cfg.intermediate_size),
    )


def _dense(gen, out_f, in_f, dtype, device, bias=False, scale=None):
    if scale is None:
        scale = in_f ** -0.5
    w = torch.randn((out_f, in_f), generator=gen, device=device) * scale
    b = torch.zeros((out_f,), dtype=dtype, device=device) if bias else None
    return DenseLinear(weight=w.to(dtype), bias=b)


def init_random_params(generator: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
                       device=None, *, dense_projs: bool = True) -> dict:
    """Random dense params. ``generator`` lives on ``device`` (None = the
    card). ``dense_projs=False`` leaves the projections out (callers that
    quantize every projection skip the dense weights)."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        layer = dict(input_norm=torch.ones((h,), dtype=dtype, device=dev),
                     post_attn_norm=torch.ones((h,), dtype=dtype, device=dev))
        if dense_projs:
            for name, (o, i) in projection_shapes(cfg).items():
                bias = cfg.attention_bias and name in ("q_proj", "k_proj", "v_proj")
                layer[name] = _dense(generator, o, i, dtype, dev, bias)
        layers.append(layer)
    embed = torch.randn((cfg.vocab_size, h), generator=generator, device=dev) * 0.02
    return dict(
        embed=embed.to(dtype),
        layers=layers,
        final_norm=torch.ones((h,), dtype=dtype, device=dev),
        lm_head=None if cfg.tie_embeddings else _dense(generator, cfg.vocab_size, h, dtype, dev),
    )


def attention_half(x, layer, cfg: ModelConfig, positions):
    """The block's attention half without a cache: x + o_proj(attention)."""
    b, t, _ = x.shape
    d = cfg.dim_per_head
    res = x
    x = rms_norm(x, layer["input_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
    q = apply_linear(x, layer["q_proj"]).reshape(b, t, cfg.num_heads, d)
    k = apply_linear(x, layer["k_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    v = apply_linear(x, layer["v_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    q, k = rope(q, k, positions, cfg.rope_theta, scaling=cfg.rope_scaling)
    attn = attention(q, k, v, make_causal_mask(positions, positions, window=cfg.sliding_window))
    return res + apply_linear(attn.reshape(b, t, -1), layer["o_proj"])


def _block(x, layer, cfg: ModelConfig, positions):
    res = x = attention_half(x, layer, cfg, positions)
    xn = rms_norm(x, layer["post_attn_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
    gate = apply_linear(xn, layer["gate_proj"])
    up = apply_linear(xn, layer["up_proj"])
    mlp_in = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return res + apply_linear(mlp_in, layer["down_proj"])


def final_norm(x, params, cfg):
    """The Llama family's final RMSNorm (Mixtral's too)."""
    return rms_norm(x, params["final_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)


def head(x, params, cfg):
    """Output head of the final-normed hidden state: logits."""
    if params.get("lm_head") is not None:
        logits = apply_linear(x, params["lm_head"])
    else:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = (torch.tanh(logits.float() / c) * c).to(x.dtype)
    return logits


def forward(params: dict, cfg: ModelConfig, input_ids: torch.Tensor, *,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal LM forward over the list of layers, without a KV cache (the
    serving form with a cache is ``models.stacked.forward_stacked``).
    Returns logits [B, T, V]."""
    b, t = input_ids.shape
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)[None, :]
    positions = positions.expand(b, t)
    x = params["embed"][input_ids]
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    for layer in params["layers"]:
        x = _block(x, layer, cfg, positions)
    return head(final_norm(x, params, cfg), params, cfg)
