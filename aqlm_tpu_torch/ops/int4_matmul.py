"""W4A16 matmul: 4-bit weights with per-128-column group scales, unpacked on chip.

PyTorch counterpart of ``aqlm_tpu.ops.int4_matmul`` (``int4_matmul`` and
``int4_matmul_indexed``). On a CUDA tensor every entry point launches the
kernel of ``csrc/int4_matmul.cu``; on a CPU tensor it runs the plain version
of the same function. The layer-indexed variant is the same kernel with a
layer pointer offset.

Layout (shared with ``aqlm_tpu``, so weights and checkpoints carry across):

- ``w4`` ``[OUT, IN_pad/2]`` uint8, block-local nibble packing: within each
  256-column block i, byte j holds column 256i + j in its low nibble and
  column 256i + 128 + j in its high nibble, so one 128-byte block unpacks to
  the groups 2i and 2i + 1. ``IN_pad = pad_in_features_int4(IN)``; padding
  columns hold q = 8, which decodes to 0.
- ``gscale`` ``[IN_pad/128, OUT]`` f32, transposed against ``w4``: one scale
  per 128-column group and output row.

Values are stored biased, q = round(w/s) + 8 in [0, 15], so
``y = sum_g s_g * (x_g . q_g - 8 * sum(x_g))``. The kernel reads only the
first ``IN`` columns of x, so activations are never padded.
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops.int8_matmul import INT8_GEMV_MAX_ROWS, _splits, pad_in_features

__all__ = [
    "GROUP",
    "INT4_GEMV_MAX_ROWS",
    "CLIP_CANDIDATES",
    "pad_in_features_int4",
    "quantize_int4",
    "unpack_int4",
    "dequantize_int4",
    "int4_matmul",
    "int4_matmul_indexed",
]

GROUP = 128  # original columns per scale group
INT4_GEMV_MAX_ROWS = INT8_GEMV_MAX_ROWS  # up to this many rows take the kernel's decode path
# tile shapes of the kernel (csrc/int4_matmul.cu), for the split-K choice
_GEMV_ROWS = 16  # output rows per decode block
_GEMM_BM, _GEMM_BN, _GEMM_BK = 64, 128, 2 * GROUP
_PLAIN_CHUNK_ELEMS = 1 << 26  # f32 elements of the plain version's per-group products at once


def pad_in_features_int4(in_features: int) -> int:
    """int4 contraction padding: whole 256-column packing blocks, and above
    1024 columns int8's multiple of 1024 (11008 -> 11264), as ``aqlm_tpu``
    stores it."""
    if in_features <= 1024:
        return -(-in_features // (2 * GROUP)) * (2 * GROUP)
    return pad_in_features(in_features)


CLIP_CANDIDATES = (1.0, 0.95, 0.9, 0.85, 0.8)


def quantize_int4(dense: torch.Tensor, mse_clip: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group symmetric int4 of a dense ``[OUT, IN]`` weight: ``(w4
    [OUT, IN_pad/2] uint8, gscale [IN_pad/128, OUT] f32)``.

    ``mse_clip`` tries the clip ratios of ``CLIP_CANDIDATES`` per group and
    keeps the scale with the least squared error. The order of operations is
    ``aqlm_tpu``'s (round half to even, the error summed over the group, a
    strict comparison), so both packages give the same bytes."""
    out_features, in_features = dense.shape
    in_pad = pad_in_features_int4(in_features)
    w = dense.float()
    if in_pad != in_features:
        w = torch.nn.functional.pad(w, (0, in_pad - in_features))
    g = w.reshape(out_features, in_pad // GROUP, GROUP)
    amax = g.abs().amax(dim=2)  # [OUT, G']

    def quant_err(scale):
        q = torch.clamp(torch.round(g / scale[:, :, None]) + 8.0, 0, 15)
        err = (((q - 8.0) * scale[:, :, None] - g) ** 2).sum(dim=2)
        return q, err

    scale = torch.clamp(amax / 7.0, min=1e-12)
    q, best_err = quant_err(scale)
    if mse_clip:
        for r in CLIP_CANDIDATES[1:]:
            s_c = torch.clamp(r * amax / 7.0, min=1e-12)
            q_c, err_c = quant_err(s_c)
            better = err_c < best_err
            scale = torch.where(better, s_c, scale)
            q = torch.where(better[:, :, None], q_c, q)
            best_err = torch.minimum(err_c, best_err)
            del q_c, err_c, better
    del g, w
    q = q.to(torch.uint8).reshape(out_features, in_pad // (2 * GROUP), 2, GROUP)
    w4 = (q[:, :, 0, :] | (q[:, :, 1, :] << 4)).reshape(out_features, in_pad // 2)
    return w4.contiguous(), scale.t().float().contiguous()


def unpack_int4(w4: torch.Tensor) -> torch.Tensor:
    """``[OUT, IN_pad/2]`` packed bytes -> ``[OUT, IN_pad/128, 128]`` int32 q."""
    out_features, half = w4.shape
    w = w4.to(torch.int32).reshape(out_features, half // GROUP, 1, GROUP)
    return torch.cat([w & 15, w >> 4], dim=2).reshape(out_features, half * 2 // GROUP, GROUP)


def dequantize_int4(w4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """``[OUT, IN_pad]`` f32: ``(q - 8) * s`` per group."""
    q = unpack_int4(w4).float() - 8.0
    return (q * gscale.t()[:, :, None]).reshape(w4.shape[0], -1)


def plain(xb, w4, gscale):
    """The kernel's plain version on one layer's arrays (same arguments as
    ``launch``), in the TPU kernel's form: per 128-column group the f32
    product of x and the raw nibbles, minus 8 times the group's sum of x,
    times the group scale, summed over the groups in order; cast to x's
    dtype. Groups are taken a chunk at a time to bound the intermediates."""
    rows, in_features = xb.shape
    n_groups = -(-in_features // GROUP)
    x = xb.float()
    if n_groups * GROUP != in_features:
        x = torch.nn.functional.pad(x, (0, n_groups * GROUP - in_features))
    x = x.reshape(rows, n_groups, GROUP).transpose(0, 1)  # [G, rows, 128]
    out_features = w4.shape[0]
    acc = torch.zeros((rows, out_features), dtype=torch.float32, device=xb.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, rows * out_features + out_features * GROUP))
    for g0 in range(0, n_groups, step):
        g1 = min(n_groups, g0 + step)
        b0, b1 = g0 // 2, -(-g1 // 2)  # the packing blocks that hold these groups
        q = unpack_int4(w4[:, b0 * GROUP:b1 * GROUP])[:, g0 - 2 * b0:g1 - 2 * b0].float()
        d = torch.bmm(x[g0:g1], q.permute(1, 2, 0))  # [g, rows, OUT]
        xs = x[g0:g1].sum(dim=2, keepdim=True)  # [g, rows, 1]
        part = (d - 8.0 * xs) * gscale[g0:g1, None, :].float()
        for i in range(g1 - g0):
            acc += part[i]
        del q, d, part
    return acc.to(xb.dtype)


def launch(xb, w4, gscale):
    """The kernel on one layer's arrays: xb [rows, IN] bf16; w4 [OUT,
    IN_pad/2] uint8; gscale [IN_pad/128, OUT] f32. Rows <= 8 take the decode
    (GEMV) path, more rows the prefill (tensor-core GEMM) path. Returns
    [rows, OUT] bf16."""
    rows, in_features = xb.shape
    out_features, ldb = w4.shape
    dev = xb.device
    if xb.dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul kernel takes bf16 activations, got {xb.dtype}")
    if w4.dtype != torch.uint8 or gscale.dtype != torch.float32:
        raise ValueError(f"int4_matmul kernel takes uint8 packed weights and f32 group scales, "
                         f"got {w4.dtype} and {gscale.dtype}")
    if in_features > 2 * ldb or in_features % 16 or ldb % GROUP:
        raise ValueError(f"int4_matmul kernel: x {tuple(xb.shape)} against w4 {tuple(w4.shape)} "
                         "(IN <= IN_pad, IN a multiple of 16, whole 256-column packing blocks)")
    if gscale.shape != (2 * ldb // GROUP, out_features):
        raise ValueError(f"gscale {tuple(gscale.shape)} does not match "
                         f"(IN_pad/128, OUT) = {(2 * ldb // GROUP, out_features)}")
    for t in (xb, w4, gscale):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("int4_matmul kernel operands must be contiguous on one CUDA device")
    if xb.data_ptr() % 16 or w4.data_ptr() % 16 or gscale.data_ptr() % 4:
        raise ValueError("int4_matmul kernel needs 16-byte aligned activations and weights")
    out = torch.empty((rows, out_features), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return out
    sms = _build.sm_count(dev.index)
    if rows <= INT4_GEMV_MAX_ROWS:
        blocks = -(-out_features // _GEMV_ROWS)
        n_units = -(-in_features // _GEMM_BK)  # packing blocks; each of the 8 warps takes some
        splits = _splits(blocks, n_units, sms, max(1, n_units // 8))
        per_split = -(-n_units // splits) * _GEMM_BK
        part_rows = rows
    else:
        row_tiles = -(-rows // _GEMM_BM)
        blocks = row_tiles * -(-out_features // _GEMM_BN)
        n_steps = -(-in_features // _GEMM_BK)
        splits = _splits(blocks, n_steps, sms, max(1, n_steps // 4))
        per_split = -(-n_steps // splits) * _GEMM_BK
        part_rows = row_tiles * _GEMM_BM
    partials = tickets = None
    if splits > 1:
        # the splits' f32 partial sums meet here; the last block of each
        # output tile to finish adds them in a fixed order
        partials = torch.empty((splits, part_rows, out_features), dtype=torch.float32, device=dev)
        tickets = torch.zeros(blocks, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.int4_matmul_launch(
        xb.data_ptr(), w4.data_ptr(), gscale.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        rows, splits, per_split, out_features, in_features, ldb, _build.stream_ptr(dev),
    )
    _build.check(rc, "int4_matmul")
    _build.KERNELS["int4_matmul"].launches += 1
    return out


def _matmul(xb, w4, gscale):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> the kernel."""
    if xb.device.type == "cpu":
        return plain(xb, w4, gscale)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, w4, gscale)


def int4_matmul(x, w4, gscale, bias=None):
    """y = x @ dequantize_int4(w4, gscale)[:, :IN].T + bias.

    x: [..., IN]; w4: [OUT, IN_pad/2] uint8; gscale: [IN_pad/128, OUT] f32;
    bias: [OUT] or None, added after the cast to x's dtype, as ``aqlm_tpu``
    adds it."""
    lead = x.shape[:-1]
    y = _matmul(x.reshape(-1, x.shape[-1]).contiguous(), w4, gscale)
    if bias is not None:
        y = y + bias[None, :].to(y.dtype)
    return y.reshape(*lead, -1)


def int4_matmul_indexed(x, w4_all, gscale_all, layer_idx: int, bias_all=None):
    """y = x @ dequant(w4_all[layer_idx]).T (+ bias_all[layer_idx]).

    w4_all: [L, OUT, IN_pad/2] uint8; gscale_all: [L, IN_pad/128, OUT] f32.
    The layer is a view of the stacked arrays: nothing is copied."""
    li = int(layer_idx)
    return int4_matmul(x, w4_all[li], gscale_all[li], None if bias_all is None else bias_all[li])
