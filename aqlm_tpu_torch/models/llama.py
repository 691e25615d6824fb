"""Llama-family causal LM (PyTorch counterpart of ``aqlm_tpu.models.llama``).

Parameters are a plain dict: every projection is a DenseLinear or a
QuantizedLinear. ``forward`` is the unstacked (list-of-layers) forward with
``aqlm_tpu``'s contract: ``(logits, caches)``, an optional per-layer KV
cache (``init_kv_cache``), the hidden state in place of the logits, and
per-block recomputation in the backward. The serving form is
``models.stacked.forward_stacked``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import (
    DenseLinear,
    apply_linear,
    attention,
    make_causal_mask,
    rms_norm,
    rope,
)

__all__ = ["ModelConfig", "init_random_params", "init_kv_cache", "forward",
           "block_forward_with_taps", "QUANTIZABLE_PROJS", "projection_shapes"]

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


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> list:
    """[layers] of (k, v) zeros, each [B, max_len, n_kv, head_dim], on
    ``device`` (None = the card): the cache of the unstacked ``forward``."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.dim_per_head)
    return [(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.num_layers)]


def attention_half(x, layer, cfg: ModelConfig, positions, taps=None, kv=None, cache_offset=0,
                   kv_mask=None, attention_fn=None):
    """The block's attention half: x + o_proj(attention). A ``taps`` dict
    receives each projection's input by name. With ``kv`` (one layer's
    (k, v) cache) the new K/V are written into it in place at
    [cache_offset, cache_offset + T) and attention runs over the whole cache
    under ``kv_mask`` [B, 1, T, max_len]. ``attention_fn`` replaces
    ``attention`` (same arguments and values)."""
    b, t, _ = x.shape
    d = cfg.dim_per_head
    res = x
    x = rms_norm(x, layer["input_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
    q = apply_linear(x, layer["q_proj"]).reshape(b, t, cfg.num_heads, d)
    k = apply_linear(x, layer["k_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    v = apply_linear(x, layer["v_proj"]).reshape(b, t, cfg.num_kv_heads, d)
    q, k = rope(q, k, positions, cfg.rope_theta, scaling=cfg.rope_scaling)
    if kv is not None:
        k_cache, v_cache = kv
        k_cache[:, cache_offset:cache_offset + t] = k.to(k_cache.dtype)
        v_cache[:, cache_offset:cache_offset + t] = v.to(v_cache.dtype)
        k, v, mask = k_cache.to(q.dtype), v_cache.to(q.dtype), kv_mask
    else:
        mask = make_causal_mask(positions, positions, window=cfg.sliding_window)
    attn = (attention_fn or attention)(q, k, v, mask).reshape(b, t, -1)
    if taps is not None:
        taps["q_proj"] = taps["k_proj"] = taps["v_proj"] = x
        taps["o_proj"] = attn
    return res + apply_linear(attn, layer["o_proj"])


def _block(x, layer, cfg: ModelConfig, positions, taps=None, kv=None, cache_offset=0,
           kv_mask=None, *, attention_fn=None, act_mul_fn=None):
    """One transformer block. ``attention_fn`` / ``act_mul_fn`` replace the
    attention and the SiLU-times-up glue with functions of the same values
    (the scanned PV student's recompute-in-backward forms,
    ``pv.straight_through``)."""
    res = x = attention_half(x, layer, cfg, positions, taps, kv, cache_offset, kv_mask,
                             attention_fn)
    xn = rms_norm(x, layer["post_attn_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
    gate = apply_linear(xn, layer["gate_proj"])
    up = apply_linear(xn, layer["up_proj"])
    if act_mul_fn is None:
        mlp_in = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    else:
        mlp_in = act_mul_fn(gate, up)
    if taps is not None:
        taps["gate_proj"] = taps["up_proj"] = xn
        taps["down_proj"] = mlp_in
    return res + apply_linear(mlp_in, layer["down_proj"])


def block_forward_with_taps(x, layer, cfg: ModelConfig, positions):
    """One block forward that also returns each projection's input activation:
    (block output, {name: input}); the calibration accumulates X^T X from the
    taps. Differentiable (the block finetune trains through it)."""
    taps = {}
    return _block(x, layer, cfg, positions, taps), taps


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


def embed_and_positions(params, cfg: ModelConfig, input_ids, positions, cache_offset):
    """The embedded tokens and the positions [B, T] the forwards share:
    ``cache_offset + arange(T)`` unless given."""
    b, t = input_ids.shape
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)[None, :] + int(cache_offset or 0)
    positions = positions.expand(b, t)
    x = params["embed"][input_ids]
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x, positions


def run_blocks(block, x, params, cfg, positions, kv_caches, cache_offset, remat_blocks):
    """``block(x, layer, cfg, positions, None, kv, cache_offset, kv_mask)``
    over the layers, each under ``torch.utils.checkpoint`` (non-reentrant)
    with ``remat_blocks``. Returns (x, caches or None)."""
    kv_mask = None
    if kv_caches is not None:  # the queries over every row of the cache
        b, max_len = positions.shape[0], kv_caches[0][0].shape[1]
        key_pos = torch.arange(max_len, device=positions.device)[None, :].expand(b, max_len)
        kv_mask = make_causal_mask(positions, key_pos, window=cfg.sliding_window)
    off = int(cache_offset or 0)
    for li, layer in enumerate(params["layers"]):
        kv = None if kv_caches is None else kv_caches[li]
        args = (x, layer, cfg, positions, None, kv, off, kv_mask)
        x = checkpoint(block, *args, use_reentrant=False) if remat_blocks else block(*args)
    return x, kv_caches


def forward(params: dict, cfg: ModelConfig, input_ids: torch.Tensor, *,
            positions: torch.Tensor | None = None, kv_caches: list | None = None,
            cache_offset=None, return_hidden: bool = False, remat_blocks: bool = False):
    """Causal LM forward over the list of layers, as ``aqlm_tpu``'s.

    Without a cache: the full-sequence forward (calibration, perplexity,
    prefill). With ``kv_caches`` (``init_kv_cache``) and ``cache_offset``
    (one offset for every row): the new K/V are written in place at
    [cache_offset, cache_offset + T) and attention runs over the cache.
    ``return_hidden`` returns the post-final-norm hidden state instead of
    the logits; ``remat_blocks`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant).

    Returns (logits [B, T, V] or hidden [B, T, H], the caches or None)."""
    x, positions = embed_and_positions(params, cfg, input_ids, positions, cache_offset)
    x, caches = run_blocks(_block, x, params, cfg, positions, kv_caches, cache_offset,
                           remat_blocks)
    x = final_norm(x, params, cfg)
    return (x if return_hidden else head(x, params, cfg)), caches
