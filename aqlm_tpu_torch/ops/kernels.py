"""Kx8 codebook dequant-matmul over the untiled codes layout, for any out_features.

PyTorch counterpart of ``aqlm_tpu.ops.kernels.fused_onehot_matmul``, the
path of every codes-mode projection whose out_features is not a multiple of
128 (Falcon-7B's q/k/v/o/fc2). On a CUDA tensor every entry point launches
kernel B15 (``csrc/onehot_matmul.cu``): a GEMV form for at most 8 rows and a
tensor-core GEMM form above; on a CPU tensor it runs the plain version.

Numerics follow the TPU kernel: each weight element is
``bf16(sum_k f32(cb_k[code_k]))``; the product accumulates in f32 and is
rounded to the activations' dtype, which is then multiplied by the scales
and added to the bias, both cast to that dtype. The bf16 rounding of the
product before the scale is where this path differs from K1/K2.

Codes layout: ``codes_t [K, IG, OUT]`` uint8 (stacked: ``[L, K, IG, OUT]``).
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build

__all__ = ["ONEHOT_GEMV_MAX_ROWS", "fused_onehot_matmul", "fused_onehot_matmul_indexed"]

ONEHOT_GEMV_MAX_ROWS = 8  # the GEMV form's largest row count; more rows take the GEMM form
_KERNEL_GROUP = 8  # in_group_size the CUDA kernel is written for


def dequant_t(codes_t: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Unscaled W^T ``[IN, OUT]`` f32 from ``codes_t [K, IG, OUT]`` and
    ``codebooks [K, S, g]``: the codebook vectors summed in f32."""
    K, ig, out = codes_t.shape
    g = codebooks.shape[-1]
    cbf = codebooks.float()
    w = None
    for k in range(K):
        part = cbf[k][codes_t[k].long()]  # [IG, OUT, g]
        w = part if w is None else w + part
    return w.permute(0, 2, 1).reshape(ig * g, out)


def plain(xb, codes_t, codebooks, scales):
    """B15's plain version on one layer's arrays (same arguments as ``launch``)."""
    wt = dequant_t(codes_t, codebooks).to(torch.bfloat16).float()
    y = torch.matmul(xb.float(), wt).to(xb.dtype)
    return y * scales.to(xb.dtype)[None, :]


def launch(xb, codes_t, codebooks, scales, group):
    """B15 on one layer's arrays: xb [B, IN] bf16 (or f32 at <= 8 rows);
    codes_t [K, IG, OUT] uint8; codebooks [K, S, 8] bf16; scales [OUT] f32.
    Returns [B, OUT] in xb's dtype."""
    K, ig, out_features = codes_t.shape
    _, S, g = codebooks.shape
    B, in_features = xb.shape
    dev = xb.device
    gemv = B <= ONEHOT_GEMV_MAX_ROWS
    if group != _KERNEL_GROUP or g != _KERNEL_GROUP:
        raise NotImplementedError(f"onehot_matmul kernel takes in_group_size 8, got {group}")
    if xb.dtype not in ((torch.bfloat16, torch.float32) if gemv else (torch.bfloat16,)):
        raise ValueError(f"onehot_matmul kernel takes bf16 activations (f32 at <= "
                         f"{ONEHOT_GEMV_MAX_ROWS} rows), got {xb.dtype} at {B} rows")
    if codes_t.dtype != torch.uint8 or codebooks.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("onehot_matmul kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if K > 8 or S > 256 or codebooks.shape[0] != K or in_features != ig * g:
        raise ValueError(f"onehot_matmul kernel: bad shapes x {tuple(xb.shape)} codes "
                         f"{tuple(codes_t.shape)} codebooks {tuple(codebooks.shape)}")
    if scales.shape != (out_features,):
        raise ValueError(f"scales {tuple(scales.shape)} do not match OUT={out_features}")
    for t in (xb, codes_t, codebooks, scales):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("onehot_matmul kernel operands must be contiguous on one CUDA device")
    if xb.data_ptr() % 16 or codebooks.data_ptr() % 16:
        raise ValueError("onehot_matmul kernel needs 16-byte aligned activations and codebooks")
    out = torch.empty((B, out_features), dtype=xb.dtype, device=dev)
    if B == 0:
        return out
    sms = _build.sm_count(dev.index)
    if gemv:
        # split the input groups of each 256-column block over enough blocks
        # to fill the card twice (k/v have one column block)
        col_blocks, n_units = -(-out_features // 256), ig
        splits = max(1, min(-(-2 * sms // col_blocks), n_units // 16))
        t_pad = B
    else:
        # split the 64-wide input slabs where the output tiles alone would
        # not fill the card twice
        row_tiles, n_units = -(-B // 128), -(-ig // 8)
        col_blocks = -(-out_features // 128) * row_tiles
        splits = max(1, min(-(-2 * sms // col_blocks), n_units // 4))
        t_pad = row_tiles * 128
    splits = -(-n_units // -(-n_units // splits))  # no empty split
    partials = tickets = None
    if splits > 1:
        partials = torch.empty((splits, t_pad, -(-out_features // 128) * 128),
                               dtype=torch.float32, device=dev)
        tickets = torch.zeros(col_blocks, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.onehot_matmul_launch(
        xb.data_ptr(), codes_t.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        int(xb.dtype == torch.bfloat16), B, splits, ig, out_features, K, S,
        int(out_features % 4 == 0 and codes_t.data_ptr() % 4 == 0), _build.stream_ptr(dev),
    )
    _build.check(rc, "onehot_matmul")
    _build.KERNELS["onehot_matmul"].launches += 1
    return out


def fused_onehot_matmul(x, codes_t, codebooks, scales, bias=None, *, group: int):
    """y = x @ dequant(codes)^T * scales + bias, codes resident, nbits <= 8.

    x: [..., IN] (any leading dims); codes_t: [K, IG, OUT] uint8;
    codebooks: [K, S<=256, g]; scales: [OUT]; bias: [OUT] or None. Output
    in x's dtype: the plain version on a CPU tensor, B15 on a CUDA one."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    if xb.device.type == "cpu":
        y = plain(xb, codes_t, codebooks, scales)
    elif xb.device.type == "cuda":
        y = launch(xb, codes_t, codebooks, scales, group)
    else:
        raise ValueError(f"unsupported device {xb.device}")
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :]
    return y.reshape(*lead, -1)


def fused_onehot_matmul_indexed(x, codes_t_all, codebooks_all, scales_all, layer_idx: int,
                                bias_all=None, *, group: int):
    """Layer ``layer_idx`` of stacked params, read in place: codes_t_all
    [L, K, IG, OUT], codebooks_all [L, K, S, g], scales_all [L, OUT],
    bias_all [L, OUT] or None."""
    li = int(layer_idx)
    return fused_onehot_matmul(x, codes_t_all[li], codebooks_all[li], scales_all[li],
                               None if bias_all is None else bias_all[li], group=group)
