"""Stacked-layer model execution and the quantizable KV cache: the serving form.

PyTorch counterpart of ``aqlm_tpu.models.stacked`` for the Llama, Mixtral
and Falcon families. Identical blocks are stacked into one set of tensors with
a leading layer axis; ``forward_stacked`` runs a Python loop over layers and
hands the kernels the stacked weights plus a layer index, so nothing is
copied per layer. A Mixtral block's stacked experts ([L, E, ...]) go whole
to the all-expert kernel with the layer index. The KV cache is a
preallocated head-major [L, B, H_kv, max_len, D] ring in bf16, or in int8
with per-(token, head) f32 scales, and is UPDATED IN PLACE:
``forward_stacked`` returns the cache object it was given.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import falcon, family, llama, mixtral
from aqlm_tpu_torch.models.common import (
    DenseLinear,
    apply_linear,
    attention,
    attention_headmajor,
    make_causal_mask,
    rms_norm,
    rope,
)
from aqlm_tpu_torch.ops.flash_decode import flash_decode_write_attention_indexed
from aqlm_tpu_torch.ops.runtime import (
    FusedCodesLinear,
    IndexedFusedCodesLinear,
    IndexedQuantizedLinear,
    QuantizedLinear,
)

__all__ = ["KVCache", "init_kv_cache", "stack_layer_params", "forward_stacked"]


@dataclasses.dataclass
class KVCache:
    """Stacked head-major KV cache. k/v: [L, B, H_kv, max_len, D] (bf16 or
    int8); scales: [L, B, H_kv, max_len, 1] f32 when int8, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def tensors(self) -> tuple:
        return tuple(t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None)

    def rows(self, start: int, stop: int) -> "KVCache":
        """A view of batch rows [start, stop): writes through it land in self."""
        pick = lambda a: None if a is None else a[:, start:stop]
        return KVCache(pick(self.k), pick(self.v), pick(self.k_scale), pick(self.v_scale))


def init_kv_cache(cfg: llama.ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
                  quantized: bool = False, device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.dim_per_head)
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), k_scale=None, v_scale=None)


def _stack(vals):
    v0 = vals[0]
    if v0 is None:
        return None
    if isinstance(v0, torch.Tensor):
        return torch.stack(vals)
    if dataclasses.is_dataclass(v0):
        kw = {}
        for f in dataclasses.fields(v0):
            if f.name in v0.data_fields:
                kw[f.name] = _stack([getattr(v, f.name) for v in vals])
            elif f.name != "proj_map":  # derived again from the stacked codes
                kw[f.name] = getattr(v0, f.name)
        return type(v0)(**kw)
    raise TypeError(f"cannot stack {type(v0).__name__}")


def stack_layer_params(params: dict, donate: bool = False) -> dict:
    """Stack the per-layer dicts into one dict of [L, ...] leaves.

    ``donate=True`` stacks leaf by leaf and drops each leaf from the
    per-layer dicts once its stacked copy exists: the peak is the model plus
    its largest stacked leaf, not twice the model."""
    layers = params["layers"]
    stacked = {}
    for name in list(layers[0]):
        stacked[name] = _stack([l[name] for l in layers])
        if donate:
            for l in layers:
                l[name] = None
    return {**params, "layers": stacked}


def _quantize_kv(x: torch.Tensor):
    """[B, T, H, D] -> int8 values + per-(token, head) f32 scale [B, T, H]."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-8)[..., None]).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return q.to(dtype) * scale.to(dtype)


def _layer_view(v, i: int):
    if isinstance(v, QuantizedLinear):
        return IndexedQuantizedLinear(stacked=v, idx=i)
    if isinstance(v, FusedCodesLinear):
        return IndexedFusedCodesLinear(stacked=v, idx=i)
    if isinstance(v, DenseLinear):
        return DenseLinear(weight=v.weight[i], bias=None if v.bias is None else v.bias[i])
    if isinstance(v, torch.Tensor):
        return v[i]
    raise TypeError(f"unsupported stacked leaf {type(v).__name__}")


def _write_rows(buf: torch.Tensor, new: torch.Tensor, offsets: list) -> None:
    """Head-major write: buf [B, H, S, ...] <- new [B, T, H, ...] at per-row
    offsets, in place. Rows past the end of the cache are dropped (they only
    ever hold a padded prefill chunk's tail)."""
    new_hm = new.movedim(1, 2)
    s_len = buf.shape[2]
    for b, off in enumerate(offsets):
        n = min(new_hm.shape[2], s_len - off)
        if n > 0:
            buf[b, :, off:off + n] = new_hm[b, :, :n]


def forward_stacked(params: dict, cfg: llama.ModelConfig, input_ids: torch.Tensor, *,
                    cache: KVCache | None = None, cache_offset=0,
                    positions: torch.Tensor | None = None):
    """Causal LM forward over stacked layers (Llama, Mixtral or Falcon
    blocks). Returns (logits, cache).

    With a cache, K/V are written IN PLACE at [offset, offset + T) of each
    row (``cache_offset``: int or [B] int tensor) and queries attend over
    positions <= their own. Single-token steps run the fused write + flash
    attention kernel (K3) when max_len % 128 == 0 and either a codes-mode
    layer is present or max_len >= 1024; otherwise attention is the
    plain head-major attention over the cache. A sparse-MoE block runs its
    stacked experts through ``mixtral.moe_mlp_stacked_indexed`` or, left
    per expert, through the per-expert loop over layer views. A Falcon block
    is the parallel one: its LayerNorm output feeds attention and the GELU
    MLP, and both add into the block input."""
    fam = family.family_name(cfg)  # raises for a family the port has not got (A9)
    stacked_layers = params["layers"]
    b, t = input_ids.shape
    dev = input_ids.device
    offsets = torch.as_tensor(cache_offset, dtype=torch.int32, device=dev).expand(b).contiguous()
    if positions is None:
        positions = offsets[:, None].long() + torch.arange(t, device=dev)[None, :]
    positions = positions.expand(b, t)

    x = params["embed"][input_ids]
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    d = cfg.dim_per_head

    has_codes = any(
        isinstance(v, FusedCodesLinear) or (isinstance(v, QuantizedLinear) and v.mode == "codes")
        for v in stacked_layers.values()
    )
    flash = (cache is not None and t == 1 and cache.max_len % 128 == 0
             and (has_codes or cache.max_len >= 1024))

    mask = None
    host_offsets = None
    if cache is not None and not flash:
        key_pos = torch.arange(cache.max_len, device=dev)[None, :].expand(b, cache.max_len)
        mask = make_causal_mask(positions, key_pos, window=cfg.sliding_window)
        host_offsets = offsets.tolist()
    elif cache is None:
        mask = make_causal_mask(positions, positions, window=cfg.sliding_window)

    for i in range(cfg.num_layers):
        # stacked experts are read in place by the all-expert kernel
        layer = {n: _layer_view(v, i) for n, v in stacked_layers.items()
                 if not n.startswith("experts_")}
        res = x
        if fam == "falcon":
            xn = falcon.layer_norm(x, layer["input_norm"], layer["input_norm_bias"], cfg.ln_eps)
        else:
            xn = rms_norm(x, layer["input_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
        if "qkv_proj" in layer:
            nq, nkv = cfg.num_heads * d, cfg.num_kv_heads * d
            qkv = apply_linear(xn, layer["qkv_proj"])
            q = qkv[..., :nq].reshape(b, t, cfg.num_heads, d)
            k = qkv[..., nq:nq + nkv].reshape(b, t, cfg.num_kv_heads, d)
            v = qkv[..., nq + nkv:].reshape(b, t, cfg.num_kv_heads, d)
        else:
            q = apply_linear(xn, layer["q_proj"]).reshape(b, t, cfg.num_heads, d)
            k = apply_linear(xn, layer["k_proj"]).reshape(b, t, cfg.num_kv_heads, d)
            v = apply_linear(xn, layer["v_proj"]).reshape(b, t, cfg.num_kv_heads, d)
        q, k = rope(q, k, positions, cfg.rope_theta, scaling=cfg.rope_scaling)

        if flash:
            if cache.quantized:
                k8, ks = _quantize_kv(k)
                v8, vs = _quantize_kv(v)
                attn = flash_decode_write_attention_indexed(
                    q, k8, v8, cache.k, cache.v, cache.k_scale, cache.v_scale, i, offsets,
                    k_scale_new=ks[..., None], v_scale_new=vs[..., None],
                    window=cfg.sliding_window,
                )[0]
            else:
                attn = flash_decode_write_attention_indexed(
                    q, k, v, cache.k, cache.v, None, None, i, offsets,
                    window=cfg.sliding_window,
                )[0]
        elif cache is not None:
            if cache.quantized:
                k8, ks = _quantize_kv(k)
                v8, vs = _quantize_kv(v)
                _write_rows(cache.k[i], k8, host_offsets)
                _write_rows(cache.v[i], v8, host_offsets)
                _write_rows(cache.k_scale[i], ks[..., None], host_offsets)
                _write_rows(cache.v_scale[i], vs[..., None], host_offsets)
                k_all = _dequantize_kv(cache.k[i], cache.k_scale[i], q.dtype)
                v_all = _dequantize_kv(cache.v[i], cache.v_scale[i], q.dtype)
            else:
                _write_rows(cache.k[i], k.to(cache.k.dtype), host_offsets)
                _write_rows(cache.v[i], v.to(cache.v.dtype), host_offsets)
                k_all, v_all = cache.k[i].to(q.dtype), cache.v[i].to(q.dtype)
            attn = attention_headmajor(q, k_all, v_all, mask)
        else:
            attn = attention(q, k, v, mask)
        attn = attn.to(x.dtype)

        attn_out = apply_linear(attn.reshape(b, t, -1), layer["o_proj"])
        if fam == "falcon":
            h1 = falcon.gelu(apply_linear(xn, layer["fc1"]), x.dtype)
            x = res + attn_out + apply_linear(h1, layer["fc2"])
            continue
        x = res + attn_out
        res = x
        xn = rms_norm(x, layer["post_attn_norm"], cfg.rms_eps, plus_one=cfg.gemma_norm)
        if "moe_gate" in layer:
            if "experts_gate_proj" in stacked_layers:
                x = res + mixtral.moe_mlp_stacked_indexed(xn, layer, stacked_layers, i, cfg)
            else:
                x = res + mixtral._moe_mlp(xn, layer, cfg)
            continue
        if "gateup_proj" in layer:
            gate, up = apply_linear(xn, layer["gateup_proj"]).chunk(2, dim=-1)
        else:
            gate = apply_linear(xn, layer["gate_proj"])
            up = apply_linear(xn, layer["up_proj"])
        mlp_in = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
        x = res + apply_linear(mlp_in, layer["down_proj"])

    if fam == "falcon":
        x = falcon.layer_norm(x, params["final_norm"], params["final_norm_bias"], cfg.ln_eps)
    else:
        x = llama.final_norm(x, params, cfg)
    return llama.head(x, params, cfg), cache
