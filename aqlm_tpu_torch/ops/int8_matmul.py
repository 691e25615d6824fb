"""W8A16 matmul: int8 weights widened on chip, each weight byte read once.

PyTorch counterpart of ``aqlm_tpu.ops.int8_matmul`` (``int8_matmul``,
``int8_matmul_indexed`` and the all-expert MoE forms ``int8_moe_matmul`` and
``int8_moe_matmul_indexed``). On a CUDA tensor every entry point launches the
kernel of ``csrc/int8_matmul.cu``; on a CPU tensor it runs the plain version
of the same function. The layer-indexed variants are the same kernel with a
layer pointer offset; the MoE forms run every expert in one launch, the
expert being one more grid axis of the same kernel.

Layout (shared with ``aqlm_tpu``, so weights and checkpoints carry across):
``w8`` is ``[OUT, IN_pad]`` int8, rows contiguous along the contraction dim,
``IN_pad = pad_in_features(IN)`` with zero columns past ``IN``;
``w_scale`` is ``[OUT]`` f32. The kernel reads only the first ``IN`` columns
of each row, so activations are never padded.
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "IN_PAD_MULTIPLE",
    "INT8_GEMV_MAX_ROWS",
    "pad_in_features",
    "quantize_int8",
    "int8_matmul",
    "int8_matmul_indexed",
    "int8_moe_matmul",
    "int8_moe_matmul_indexed",
]

IN_PAD_MULTIPLE = 1024  # weight rows padded so large contraction tiles divide evenly
INT8_GEMV_MAX_ROWS = 8  # up to this many rows take the kernel's decode path
# tile shapes of the kernel (csrc/int8_matmul.cu), for the split-K choice
_GEMV_ROWS, _GEMV_CHUNK = 16, 1024
_GEMM_BM, _GEMM_BN, _GEMM_BK = 128, 128, 64


def pad_in_features(in_features: int) -> int:
    """Contraction-dim padding of the [OUT, IN] int8 layout: a multiple of
    1024 above 1024 columns (11008 -> 11264), as ``aqlm_tpu`` stores it."""
    if in_features <= IN_PAD_MULTIPLE:
        return in_features
    return -(-in_features // IN_PAD_MULTIPLE) * IN_PAD_MULTIPLE


def quantize_int8(dense: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel int8 of a dense f32 ``[OUT, IN]`` weight: ``(w8
    [OUT, IN_pad] int8, w8_scale [OUT] f32)``, in ``aqlm_tpu``'s order of
    operations (round half to even), so both packages give the same bytes."""
    amax = dense.abs().amax(dim=1, keepdim=True)
    w8_scale = (amax / 127.0).reshape(-1)
    w8 = torch.round(dense / torch.clamp(amax, min=1e-12) * 127.0).to(torch.int8)
    in_pad = pad_in_features(w8.shape[1])
    if in_pad != w8.shape[1]:
        w8 = torch.nn.functional.pad(w8, (0, in_pad - w8.shape[1]))
    return w8.contiguous(), w8_scale.float()


def plain(xb, w8, w_scale):
    """The kernel's plain version on one layer's arrays (same arguments as
    ``launch``): f32 product of x and the widened weights, times the scale,
    cast to x's dtype."""
    w = w8[:, : xb.shape[1]].float()
    y = torch.matmul(xb.float(), w.t()) * w_scale.float()[None, :]
    return y.to(xb.dtype)


def _splits(blocks: int, n_units: int, sms: int, most: int) -> int:
    """Contraction splits that bring ``blocks`` to twice the card's SMs,
    at most ``most``, with no empty split."""
    splits = max(1, min(-(-2 * sms // blocks), most))
    return -(-n_units // -(-n_units // splits))


def moe_plain(xb, w8, w_scale):
    """The MoE kernel's plain version (same arguments as ``moe_launch``): per
    expert, the f32 product of its activations (xb [rows, IN] shared, or xb
    [E, rows, IN]) and its widened weights, times its scales, cast to x's
    dtype. Returns [E, rows, OUT]."""
    w = w8[..., : xb.shape[-1]].float()
    y = torch.matmul(xb.float(), w.transpose(1, 2)) * w_scale.float()[:, None, :]
    return y.to(xb.dtype)


def _run(xb, w8, w_scale, name, x_per_expert):
    """Check the operands of one launch (w8 [E, OUT, IN_pad], w_scale [E,
    OUT], xb [rows, IN] or [E, rows, IN]), size the split-K and launch.
    Returns [E, rows, OUT] bf16."""
    rows, in_features = xb.shape[-2:]
    experts, out_features, ld = w8.shape
    dev = xb.device
    if xb.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes bf16 activations, got {xb.dtype}")
    if w8.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes int8 weights and f32 scales, got "
                         f"{w8.dtype} and {w_scale.dtype}")
    if in_features > ld or in_features % 16 or ld % 16:
        raise ValueError(f"{name} kernel: x {tuple(xb.shape)} against w8 {tuple(w8.shape)} "
                         "(IN <= IN_pad, both multiples of 16)")
    if x_per_expert and xb.shape[0] != experts:
        raise ValueError(f"{name} kernel: per-expert x {tuple(xb.shape)} against {experts} experts")
    if w_scale.shape != (experts, out_features):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} does not match OUT={out_features}")
    for t in (xb, w8, w_scale):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} kernel operands must be contiguous on one CUDA device")
    if xb.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned activations and weights")
    out = torch.empty((experts, rows, out_features), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return out
    sms = _build.sm_count(dev.index)
    if rows <= INT8_GEMV_MAX_ROWS:
        blocks = -(-out_features // _GEMV_ROWS)
        n_chunks = -(-in_features // _GEMV_CHUNK)
        splits = _splits(experts * blocks, n_chunks, sms, n_chunks)
        per_split = -(-n_chunks // splits) * _GEMV_CHUNK
        part_rows = rows
    else:
        row_tiles = -(-rows // _GEMM_BM)
        blocks = row_tiles * -(-out_features // _GEMM_BN)
        n_slabs = -(-in_features // _GEMM_BK)
        splits = _splits(experts * blocks, n_slabs, sms, max(1, n_slabs // 4))
        per_split = -(-n_slabs // splits) * _GEMM_BK
        part_rows = row_tiles * _GEMM_BM
    partials = tickets = None
    if splits > 1:
        # each expert's splits' f32 partial sums meet here; the last block of
        # each output tile to finish adds them in a fixed order
        partials = torch.empty((experts, splits, part_rows, out_features), dtype=torch.float32,
                               device=dev)
        tickets = torch.zeros(experts * blocks, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.int8_matmul_launch(
        xb.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        experts, int(x_per_expert), rows, splits, per_split, out_features, in_features, ld,
        _build.stream_ptr(dev),
    )
    _build.check(rc, name)
    _build.KERNELS[name].launches += 1
    return out


def launch(xb, w8, w_scale):
    """The kernel on one layer's arrays: xb [rows, IN] bf16; w8 [OUT, IN_pad]
    int8; w_scale [OUT] f32. Rows <= 8 take the decode (GEMV) path, more
    rows the prefill (tensor-core GEMM) path. Returns [rows, OUT] bf16."""
    if w8.dim() != 2 or w_scale.dim() != 1:
        raise ValueError(f"int8_matmul kernel takes w8 [OUT, IN_pad] and w_scale [OUT], got "
                         f"{tuple(w8.shape)} and {tuple(w_scale.shape)}")
    return _run(xb, w8[None], w_scale[None], "int8_matmul", False)[0]


def moe_launch(xb, w8, w_scale):
    """The kernel over every expert of one layer in one launch: xb [rows, IN]
    bf16 (shared by the experts) or [E, rows, IN] (one slab per expert); w8
    [E, OUT, IN_pad] int8; w_scale [E, OUT] f32. Returns [E, rows, OUT] bf16."""
    if w8.dim() != 3 or xb.dim() not in (2, 3):
        raise ValueError(f"int8_moe_matmul kernel takes w8 [E, OUT, IN_pad] and x [rows, IN] or "
                         f"[E, rows, IN], got {tuple(w8.shape)} and {tuple(xb.shape)}")
    return _run(xb, w8, w_scale, "int8_moe_matmul", xb.dim() == 3)


def _matmul(xb, w8, w_scale):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> the kernel."""
    if xb.device.type == "cpu":
        return plain(xb, w8, w_scale)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, w8, w_scale)


def int8_matmul(x, w8, w_scale, bias=None):
    """y = (x @ w8[:, :IN].T) * w_scale + bias.

    x: [..., IN]; w8: [OUT, IN_pad] int8; w_scale: [OUT] f32; bias: [OUT]
    or None, added after the cast to x's dtype, as ``aqlm_tpu`` adds it."""
    lead = x.shape[:-1]
    y = _matmul(x.reshape(-1, x.shape[-1]).contiguous(), w8, w_scale)
    if bias is not None:
        y = y + bias[None, :].to(y.dtype)
    return y.reshape(*lead, -1)


def int8_matmul_indexed(x, w8_all, scale_all, layer_idx: int, bias_all=None):
    """y = (x @ w8_all[layer_idx].T) * scale_all[layer_idx] (+ bias_all[layer_idx]).

    w8_all: [L, OUT, IN_pad] int8; scale_all: [L, OUT] f32. The layer is a
    view of the stacked arrays: nothing is copied."""
    li = int(layer_idx)
    return int8_matmul(x, w8_all[li], scale_all[li], None if bias_all is None else bias_all[li])


def int8_moe_matmul(x, w8_all, scale_all):
    """All-expert int8 matmul: y[e] = x(e) @ w8_all[e, :, :IN].T * scale_all[e].

    x: [N, IN] shared by every expert, or [E, N, IN] per expert; w8_all:
    [E, OUT, IN_pad] int8; scale_all: [E, OUT] f32. Returns [E, N, OUT] in
    x's dtype: the MoE serving form in which every token runs through every
    expert (the routing weights zero the unrouted ones), in one launch."""
    xb = x.contiguous()
    if xb.device.type == "cpu":
        return moe_plain(xb, w8_all, scale_all)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return moe_launch(xb, w8_all, scale_all)


def int8_moe_matmul_indexed(x, w8_all, scale_all, layer_idx: int):
    """y[e] = x(e) @ w8_all[layer_idx, e].T * scale_all[layer_idx, e].

    w8_all: [L, E, OUT, IN_pad] int8; scale_all: [L, E, OUT] f32; x [N, IN]
    or [E, N, IN]. The layer is a view of the stacked arrays: nothing is
    copied. Returns [E, N, OUT]."""
    li = int(layer_idx)
    return int8_moe_matmul(x, w8_all[li], scale_all[li])
