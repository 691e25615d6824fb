"""Mixtral-style sparse-MoE causal LM (PyTorch counterpart of
``aqlm_tpu.models.mixtral``).

Attention is the Llama block's; the MLP is a router (``moe_gate``, kept
dense as the reference keeps it) and ``num_experts`` SwiGLU experts with
top-k softmax routing and renormalisation (HF Mixtral semantics). Experts
run densely, as in ``aqlm_tpu``: every expert computes every token and the
routing weights, zero for unrouted experts, combine them.

Layer params are a flat dict (the attention projections, ``moe_gate`` and
``experts.{e}.{gate,up,down}_proj``). For serving, int8, int4 and Kx8
codes experts are stacked into ``[E, ...]`` operands (``stack_experts``) and
run in one all-expert kernel launch per projection
(``ops.int8_matmul.int8_moe_matmul``, ``ops.int4_matmul.int4_moe_matmul``,
``ops.lut_gemv.lut_moe_gemv_kx8``; the last returns f32 and, past 8 rows,
runs the prefill kernel's expert grid axis).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear, apply_linear, rms_norm
from aqlm_tpu_torch.ops.int4_matmul import int4_moe_matmul, int4_moe_matmul_indexed
from aqlm_tpu_torch.ops.int8_matmul import int8_moe_matmul, int8_moe_matmul_indexed
from aqlm_tpu_torch.ops.lut_gemv import (
    LUT_GEMV_MAX_BATCH,
    lut_moe_gemv_kx8,
    lut_moe_gemv_kx8_indexed,
    tile_codes,
)
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported

__all__ = [
    "MixtralConfig", "StackedInt8Experts", "StackedInt4Experts", "StackedCodesExperts",
    "init_random_params", "forward", "block_forward_with_taps",
    "projection_shapes", "quantizable_proj_names", "stack_experts", "moe_mlp_stacked",
    "moe_mlp_stacked_indexed",
]

ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
EXPERT_PROJS = ("gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.ModelConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
                   num_heads=32, num_kv_heads=8, rope_theta=1e6, max_position_embeddings=32768,
                   num_experts=8, num_experts_per_tok=2)

    @classmethod
    def tiny_moe(cls, **kw) -> "MixtralConfig":
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_position_embeddings=128,
                        num_experts=4, num_experts_per_tok=2)
        defaults.update(kw)
        return cls(**defaults)


def quantizable_proj_names(cfg: MixtralConfig) -> tuple:
    names = list(ATTN_PROJS)
    for e in range(cfg.num_experts):
        names += [f"experts.{e}.{p}" for p in EXPERT_PROJS]
    return tuple(names)


def projection_shapes(cfg: MixtralConfig) -> dict:
    """(out_features, in_features) of each quantizable projection (the
    router ``moe_gate`` is not one)."""
    attn = llama.projection_shapes(cfg)
    h, i = cfg.hidden_size, cfg.intermediate_size
    expert = dict(gate_proj=(i, h), up_proj=(i, h), down_proj=(h, i))
    return {n: attn[n] if n in attn else expert[n.rsplit(".", 1)[1]]
            for n in quantizable_proj_names(cfg)}


def init_random_params(generator: torch.Generator, cfg: MixtralConfig, dtype=torch.bfloat16,
                       device=None, *, dense_projs: bool = True) -> dict:
    """Random dense params on ``device`` (None = the card). The router is
    always made; ``dense_projs=False`` leaves the attention and expert
    projections out (callers that quantize every one of them skip the dense
    weights: Mixtral-8x7B's experts alone are 94 GB in bf16)."""
    dev = resolve_device(device)
    params = llama.init_random_params(generator, cfg, dtype=dtype, device=dev, dense_projs=False)
    h = cfg.hidden_size
    for layer in params["layers"]:
        if dense_projs:
            for name, (o, i) in projection_shapes(cfg).items():
                layer[name] = llama._dense(generator, o, i, dtype, dev)
        layer["moe_gate"] = llama._dense(generator, cfg.num_experts, h, dtype, dev)
    return params


def _routing(xn: torch.Tensor, layer: dict, cfg: MixtralConfig) -> torch.Tensor:
    """Top-k softmax routing with renormalisation: per-expert combine weights
    [B, T, E] in f32, zero for unrouted experts. Every expert whose
    probability reaches the k-th largest is kept, so an exact tie keeps more
    than k, as in ``aqlm_tpu``."""
    logits = apply_linear(xn, layer["moe_gate"]).float()
    probs = torch.softmax(logits, dim=-1)
    threshold = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).values[..., -1:]
    weights = torch.where(probs >= threshold, probs, torch.zeros_like(probs))
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)


def _moe_mlp(xn: torch.Tensor, layer: dict, cfg: MixtralConfig) -> torch.Tensor:
    """The per-expert loop: every expert over every token, each weighted in
    xn's dtype and added in expert order."""
    weights = _routing(xn, layer, cfg)
    out = torch.zeros_like(xn)
    for e in range(cfg.num_experts):
        w_e = weights[..., e].to(xn.dtype)[..., None]
        gate = apply_linear(xn, layer[f"experts.{e}.gate_proj"])
        up = apply_linear(xn, layer[f"experts.{e}.up_proj"])
        mlp_in = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
        out = out + w_e * apply_linear(mlp_in, layer[f"experts.{e}.down_proj"])
    return out


@dataclasses.dataclass
class StackedInt8Experts:
    """All experts of one projection: w8 [E, OUT, IN_pad] int8 and scale
    [E, OUT] f32 (a leading L axis once the layers are stacked), the
    operand of ``int8_moe_matmul``."""

    w8: torch.Tensor
    scale: torch.Tensor

    data_fields: ClassVar[tuple] = ("w8", "scale")


@dataclasses.dataclass
class StackedInt4Experts:
    """All experts of one projection in the W4A16 layout: w4 [E, OUT,
    IN_pad/2] packed nibbles and gscale [E, IN_pad/128, OUT] f32 (a leading
    L axis once the layers are stacked), the operand of ``int4_moe_matmul``."""

    w4: torch.Tensor
    gscale: torch.Tensor

    data_fields: ClassVar[tuple] = ("w4", "gscale")


@dataclasses.dataclass
class StackedCodesExperts:
    """All experts of one projection in the tiled Kx8 codes layout:
    codes_tl [E, NT, K*IG, tn] uint8, codebooks [E, K, S, g] bf16, scales
    [E, OUT] f32 (a leading L axis once the layers are stacked), the operand
    of ``lut_moe_gemv_kx8``."""

    codes_tl: torch.Tensor
    codebooks: torch.Tensor
    scales: torch.Tensor
    group: int  # in_group_size
    num_codebooks: int

    data_fields: ClassVar[tuple] = ("codes_tl", "codebooks", "scales")


def _stack_codes(ws: list) -> StackedCodesExperts:
    """Kx8 codes experts, tiled where they were not, as ``aqlm_tpu`` stacks them."""
    if any(w.scheme.nbits_per_codebook > 8 for w in ws):
        raise NotImplementedError(
            "stack_experts takes Kx8 codes experts; transcode 1x16 experts to 2x8 or int8 for "
            "stacked serving")
    if any(w.bias is not None for w in ws):
        raise ValueError("stacked codes experts take no bias")
    sch = ws[0].scheme
    return StackedCodesExperts(
        codes_tl=torch.stack([w.codes_tl if w.codes_tl is not None else tile_codes(w.codes_t)
                              for w in ws]),
        codebooks=torch.stack([w.codebooks for w in ws]),
        scales=torch.stack([w.scales for w in ws]),
        group=sch.in_group_size, num_codebooks=sch.num_codebooks)


# mode -> (stacked class, the QuantizedLinear fields it stacks, in order)
_STACKED = {"int8": (StackedInt8Experts, ("w8", "w8_scale")),
            "int4": (StackedInt4Experts, ("w4", "w4_gscale"))}
# stacked class -> (all-expert kernel, its layer-indexed form)
_MOE_MATMUL = {StackedInt8Experts: (int8_moe_matmul, int8_moe_matmul_indexed),
               StackedInt4Experts: (int4_moe_matmul, int4_moe_matmul_indexed)}


def stack_experts(layer: dict, cfg: MixtralConfig, donate: bool = False) -> dict:
    """Stack the per-expert projections into ``experts_{gate,up,down}_proj``:
    [E, OUT, IN] tensors for dense experts, ``StackedInt8Experts``,
    ``StackedInt4Experts`` or ``StackedCodesExperts`` for int8, int4 or Kx8
    codes ones. Returns a layer dict without the ``experts.{e}.*`` keys.

    ``donate=True`` works in place: each projection's per-expert weights
    leave ``layer`` once their stacked copy exists, so a model the size of
    the card stacks with one projection's experts of headroom."""
    out = layer if donate else {k: v for k, v in layer.items() if not k.startswith("experts.")}
    for proj in EXPERT_PROJS:
        names = [f"experts.{e}.{proj}" for e in range(cfg.num_experts)]
        ws = [layer[n] for n in names]
        modes = {w.mode if isinstance(w, QuantizedLinear) else type(w).__name__ for w in ws}
        mode = modes.pop() if len(modes) == 1 else None
        if mode == "DenseLinear":
            stacked = torch.stack([w.weight for w in ws])
        elif mode in _STACKED:
            if any(w.bias is not None for w in ws):
                raise ValueError(f"stacked {mode} experts take no bias")
            cls, fields = _STACKED[mode]
            stacked = cls(*(torch.stack([getattr(w, f) for w in ws]) for f in fields))
        elif mode == "codes":
            stacked = _stack_codes(ws)
        else:
            raise NotImplementedError("stack_experts takes dense, int8-, int4- or Kx8 codes-mode "
                                      "experts, all alike")
        del ws
        if donate:
            for n in names:
                del layer[n]
        out[f"experts_{proj}"] = stacked
    return out


def _expert_ffn(flat: torch.Tensor, stacked: dict, idx: int | None = None) -> torch.Tensor:
    """The three all-expert projections on flattened tokens [N, H]: [E, N, H].

    ``stacked`` holds ``experts_{gate,up,down}_proj``, each a
    ``StackedInt8Experts`` or ``StackedInt4Experts`` (one launch of the int8
    or int4 kernel for all experts) or a dense [E, OUT, IN] tensor; with
    ``idx``, they carry a leading L axis and layer ``idx`` is read in place.
    Down takes each expert's own rows."""
    gw, uw, dw = (stacked[f"experts_{p}"] for p in EXPERT_PROJS)
    if type(gw) in _MOE_MATMUL:
        moe, moe_indexed = _MOE_MATMUL[type(gw)]
        operands = lambda q: [getattr(q, f) for f in q.data_fields]
        if idx is None:
            mm = lambda x, q: moe(x, *operands(q))
        else:
            mm = lambda x, q: moe_indexed(x, *operands(q), idx)
    else:
        mm = lambda x, w: torch.matmul(x, (w if idx is None else w[idx]).to(x.dtype).transpose(1, 2))
    gate = mm(flat, gw)  # [E, N, I]
    up = mm(flat, uw)
    act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return mm(act, dw)


def _codes_act(gate: torch.Tensor, up: torch.Tensor, dtype) -> torch.Tensor:
    """silu(gate) * up in f32 (both f32 [E, N, I]), rounded once to the
    activations' dtype for the down projection, as ``aqlm_tpu``'s LUT path."""
    return (torch.nn.functional.silu(gate) * up).to(dtype)


def _moe_codes_ffn(flat: torch.Tensor, gate_q: StackedCodesExperts, up_q: StackedCodesExperts,
                   down_q: StackedCodesExperts) -> torch.Tensor:
    """The stacked codes experts' FFN on flattened tokens [N, H]: f32 [E, N, H].

    At most 8 rows: one all-expert launch per projection. More rows: the
    gather-prefill matmul per expert, as ``aqlm_tpu``'s ``_moe_codes_ffn``
    (its outputs in the activations' dtype, SiLU rounded like the dense MLP)."""
    from aqlm_tpu_torch.ops.gather_prefill import gather_prefill_matmul

    if flat.shape[0] <= LUT_GEMV_MAX_BATCH:
        mm = lambda v, q: lut_moe_gemv_kx8(v, q.codes_tl, q.codebooks, q.scales, group=q.group)
        return mm(_codes_act(mm(flat, gate_q), mm(flat, up_q), flat.dtype), down_q)
    outs = []
    for e in range(gate_q.codes_tl.shape[0]):
        proj = lambda q, v: gather_prefill_matmul(v, q.codes_tl[e], q.codebooks[e], q.scales[e],
                                                  group=q.group)
        gate = proj(gate_q, flat)
        up = proj(up_q, flat)
        act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
        outs.append(proj(down_q, act))
    return torch.stack(outs).float()


def _combine(down: torch.Tensor, weights: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """sum_e down[e] * weights[..., e], the weights rounded to xn's dtype
    first and the sum taken in f32 and rounded once, as ``aqlm_tpu``'s
    einsum does."""
    b, t, h = xn.shape
    down = down.to(xn.dtype).reshape(-1, b, t, h)
    w = weights.to(xn.dtype)
    return torch.einsum("ebth,bte->bth", down.float(), w.float()).to(xn.dtype)


def moe_mlp_stacked(xn: torch.Tensor, layer: dict, cfg: MixtralConfig) -> torch.Tensor:
    """The MoE FFN of one layer whose experts ``stack_experts`` stacked: one
    all-expert contraction per projection."""
    weights = _routing(xn, layer, cfg)
    gate_w = layer["experts_gate_proj"]
    if isinstance(gate_w, torch.Tensor):  # dense: the combine weights fold in before down
        up_w, down_w = layer["experts_up_proj"], layer["experts_down_proj"]
        gate = torch.einsum("bth,eih->btei", xn, gate_w.to(xn.dtype))
        up = torch.einsum("bth,eih->btei", xn, up_w.to(xn.dtype))
        act = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
        act = act * weights.to(xn.dtype)[..., None]
        return torch.einsum("btei,ehi->bth", act, down_w.to(xn.dtype))
    flat = xn.reshape(-1, xn.shape[-1])
    if isinstance(gate_w, StackedCodesExperts):
        down = _moe_codes_ffn(flat, gate_w, layer["experts_up_proj"], layer["experts_down_proj"])
        return _combine(down, weights, xn)
    return _combine(_expert_ffn(flat, layer), weights, xn)


def moe_mlp_stacked_indexed(xn: torch.Tensor, layer: dict, stacked_layers: dict, idx: int,
                            cfg: MixtralConfig) -> torch.Tensor:
    """The MoE FFN of layer ``idx`` of the stacked model: ``layer`` is that
    layer's view (it supplies the router), ``stacked_layers`` holds the
    [L, E, ...] experts, which the kernel reads in place (the layer is a
    pointer offset)."""
    weights = _routing(xn, layer, cfg)
    flat = xn.reshape(-1, xn.shape[-1])
    gw = stacked_layers["experts_gate_proj"]
    if isinstance(gw, StackedCodesExperts):
        # any number of rows through the all-expert function, as aqlm_tpu
        mm = lambda v, q: lut_moe_gemv_kx8_indexed(v, q.codes_tl, q.codebooks, q.scales, idx,
                                                   group=q.group)
        act = _codes_act(mm(flat, gw), mm(flat, stacked_layers["experts_up_proj"]), flat.dtype)
        down = mm(act, stacked_layers["experts_down_proj"])
    else:
        down = _expert_ffn(flat, stacked_layers, idx)
    return _combine(down, weights, xn)


def block_forward_with_taps(x, layer, cfg: MixtralConfig, positions):
    raise not_ported("Mixtral calibration taps", "A12")


def _block(x, layer, cfg: MixtralConfig, positions, taps=None, kv=None, cache_offset=0,
           kv_mask=None):
    res = x = llama.attention_half(x, layer, cfg, positions, taps, kv, cache_offset, kv_mask)
    xn = rms_norm(x, layer["post_attn_norm"], cfg.rms_eps)
    return res + _moe_mlp(xn, layer, cfg)


def forward(params: dict, cfg: MixtralConfig, input_ids: torch.Tensor, *,
            positions: torch.Tensor | None = None, kv_caches: list | None = None,
            cache_offset=None, return_hidden: bool = False, remat_blocks: bool = False):
    """Causal LM forward over the list of layers, with ``llama.forward``'s
    contract (the serving form is ``models.stacked.forward_stacked``).
    Returns (logits or the post-final-norm hidden state, the caches or None)."""
    x, positions = llama.embed_and_positions(params, cfg, input_ids, positions, cache_offset)
    x, caches = llama.run_blocks(_block, x, params, cfg, positions, kv_caches, cache_offset,
                                 remat_blocks)
    x = llama.final_norm(x, params, cfg)
    return (x if return_hidden else llama.head(x, params, cfg)), caches
