"""Kx8 gather-dequant prefill GEMM over the tiled codes layout.

PyTorch counterpart of ``aqlm_tpu.ops.gather_prefill``. On a CUDA tensor
every matmul entry point launches kernel K2 (``csrc/gather_prefill.cu``), and
``gather_dequant_wt`` (the dense W^T of the codes-mode backward) launches
B5 (``csrc/gather_dequant_wt.cu``); on a CPU tensor each runs its plain
version. Numerics follow the TPU kernels: the codebook vectors are summed in
f32 and rounded to bf16 before the product, which accumulates in f32; scales
apply in the epilogue (for B5: times the f32 sum, then one rounding).
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops.lut_gemv import dequant_tiled_t, proj_map_for

__all__ = [
    "gather_prefill_matmul",
    "gather_prefill_matmul_indexed",
    "gather_prefill_matmul_grouped_indexed",
    "gather_dequant_wt",
]

_KERNEL_GROUP = 8
_KERNEL_BK = 64  # input-slab width of the kernel


def plain(xb, codes_tl, codebooks, scales, proj_map, out_dtype=None):
    """K2's plain version on one layer's arrays (same arguments as ``launch``)."""
    wt = dequant_tiled_t(codes_tl, codebooks, proj_map).to(torch.bfloat16).float()
    y = torch.matmul(xb.float(), wt) * scales.float()[None, :]
    return y.to(out_dtype or xb.dtype)


def launch(xb, codes_tl, codebooks, scales, proj_map, group, out_dtype=torch.bfloat16, out=None,
           counter="gather_prefill"):
    """K2 on one layer's arrays: xb [T, IN] bf16; codes_tl [NT, K*IG, tn]
    uint8; codebooks [P, K, S, 8] bf16; scales [OUT] f32; proj_map or None.
    The output is bf16 or f32 (``out_dtype``), written into ``out`` when
    given; the launch counts on ``counter``'s kernel."""
    nt, kig, tn = codes_tl.shape
    P, K, S, g = codebooks.shape
    T, in_features = xb.shape
    dev = xb.device
    if group != _KERNEL_GROUP or g != _KERNEL_GROUP:
        raise NotImplementedError(f"gather_prefill kernel takes in_group_size 8, got {group}")
    if xb.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_prefill kernel takes bf16 activations and a bf16 or f32 output, "
                         f"got {xb.dtype} -> {out_dtype}")
    if codes_tl.dtype != torch.uint8 or codebooks.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("gather_prefill kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if (K > 8 or S > 256 or kig % K or in_features != kig // K * g
            or in_features % _KERNEL_BK or tn % 128):
        raise ValueError(f"gather_prefill kernel: bad shapes x {tuple(xb.shape)} codes "
                         f"{tuple(codes_tl.shape)} codebooks {tuple(codebooks.shape)}")
    if scales.shape != (nt * tn,):
        raise ValueError(f"scales {tuple(scales.shape)} do not match OUT={nt * tn}")
    if proj_map is not None and (proj_map.dtype != torch.int32 or proj_map.shape != (nt,)):
        raise ValueError("proj_map must be int32 [NT]")
    for t in (xb, codes_tl, codebooks, scales) + (() if proj_map is None else (proj_map,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gather_prefill kernel operands must be contiguous on one CUDA device")
    if P > 1 and proj_map is None:
        raise ValueError("grouped codebooks need a proj_map")
    if codes_tl.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("gather_prefill kernel needs 16-byte aligned codes and activations")
    if out is None:
        out = torch.empty((T, nt * tn), dtype=out_dtype, device=dev)
    elif (out.shape != (T, nt * tn) or out.dtype != out_dtype or out.device != dev
          or not out.is_contiguous()):
        raise ValueError("gather_prefill kernel: bad output buffer")
    if T == 0:
        return out
    # split the input dimension over blocks when the output tiles alone
    # would not fill the card twice; the blocks' partial sums meet in `partials`
    tiles, row_tiles, n_slabs = nt * tn // 128, -(-T // 128), in_features // _KERNEL_BK
    splits = max(1, min(-(-2 * _build.sm_count(dev.index) // (tiles * row_tiles)), n_slabs // 4))
    splits = -(-n_slabs // -(-n_slabs // splits))  # no empty split
    partials = tickets = None
    if splits > 1:
        partials = torch.empty((splits, row_tiles * 128, nt * tn), dtype=torch.float32, device=dev)
        tickets = torch.zeros(row_tiles * tiles, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.gather_prefill_launch(
        xb.data_ptr(), codes_tl.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
        None if proj_map is None else proj_map.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), int(out_dtype == torch.bfloat16),
        T, splits, nt, kig, tn, K, S, in_features, _build.stream_ptr(dev),
    )
    _build.check(rc, "gather_prefill")
    _build.KERNELS[counter].launches += 1
    return out


def _matmul(xb, codes_tl, codebooks, scales, proj_map, group):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> K2."""
    if xb.device.type == "cpu":
        return plain(xb, codes_tl, codebooks, scales, proj_map)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, codes_tl, codebooks, scales, proj_map, group)


def _add_bias(y, bias):
    return (y.float() + bias[None, :].float()).to(y.dtype)


def gather_prefill_matmul(x, codes_tl, codebooks, scales, bias=None, *, group: int):
    """y = x @ dequant(codes)^T * scales + bias over the tiled codes layout.

    x: [..., IN]; codes_tl: [NT, K*IG, tn] uint8; codebooks: [K, S<=256, g];
    scales: [OUT]; bias: [OUT] or None."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    y = _matmul(xb, codes_tl, codebooks[None], scales, None, group)
    if bias is not None:
        y = _add_bias(y, bias)
    return y.reshape(*lead, -1)


def gather_prefill_matmul_indexed(x, codes_tl_all, codebooks_all, scales_all, layer_idx: int,
                                  bias_all=None, *, group: int):
    """Layer ``layer_idx`` of stacked params: codes_tl_all [L, NT, K*IG, tn],
    codebooks_all [L, K, S, g], scales_all [L, OUT]."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    li = int(layer_idx)
    y = _matmul(xb, codes_tl_all[li], codebooks_all[li][None], scales_all[li], None, group)
    if bias_all is not None:
        y = _add_bias(y, bias_all[li])
    return y.reshape(*lead, -1)


def gather_prefill_matmul_grouped_indexed(x, codes_tl_all, codebooks_all, scales_all, out_sizes,
                                          layer_idx: int, *, group: int, proj_map=None):
    """Fused-projection prefill of layer ``layer_idx`` in one launch
    (codebooks_all [L, P, K, S, g]; see ``lut_gemv_kx8_grouped_indexed``)."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    _, nt, _, tn = codes_tl_all.shape
    if codebooks_all.shape[1] != len(out_sizes) or sum(out_sizes) != nt * tn:
        raise ValueError(f"out_sizes {out_sizes} do not match the fused codes {tuple(codes_tl_all.shape)}")
    if proj_map is None:
        proj_map = proj_map_for(out_sizes, tn, x.device)
    li = int(layer_idx)
    y = _matmul(xb, codes_tl_all[li], codebooks_all[li], scales_all[li], proj_map, group)
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# B5: the dense W^T from tiled codes (the codes-mode activation backward)
# ---------------------------------------------------------------------------


def dequant_wt_plain(codes_tl, codebooks, scales, dtype=torch.bfloat16):
    """B5's plain version (same arguments as ``dequant_wt_launch``): the f32
    codebook vectors summed in codebook order from k = 0, times the f32
    scales, rounded once to ``dtype``. Returns W^T [IN, OUT]."""
    wt = dequant_tiled_t(codes_tl, codebooks[None])
    return (wt * scales.float()[None, :]).to(dtype)


def dequant_wt_launch(codes_tl, codebooks, scales, dtype=torch.bfloat16):
    """B5 on the card: codes_tl [NT, K*IG, tn] uint8 (ig-major rows);
    codebooks [K, S<=256, 8] bf16; scales [OUT] f32; ``dtype`` bf16 or f32.
    Returns W^T [IN, OUT] in ``dtype``."""
    nt, kig, tn = codes_tl.shape
    K, S, g = codebooks.shape
    dev = codes_tl.device
    if g != _KERNEL_GROUP:
        raise NotImplementedError(f"gather_dequant_wt kernel takes in_group_size 8, got {g}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_dequant_wt kernel writes bf16 or f32, got {dtype}")
    if (codes_tl.dtype != torch.uint8 or codebooks.dtype != torch.bfloat16
            or scales.dtype != torch.float32):
        raise ValueError("gather_dequant_wt kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if K < 1 or K > 8 or S > 256 or kig % K:
        raise ValueError(f"gather_dequant_wt kernel: bad shapes codes {tuple(codes_tl.shape)} "
                         f"codebooks {tuple(codebooks.shape)}")
    if scales.shape != (nt * tn,):
        raise ValueError(f"scales {tuple(scales.shape)} do not match OUT={nt * tn}")
    for t in (codes_tl, codebooks, scales):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gather_dequant_wt kernel operands must be contiguous on one CUDA device")
    out = torch.empty((kig // K * g, nt * tn), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    lib, _ = _build.library()
    rc = lib.gather_dequant_wt_launch(codes_tl.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
                                      out.data_ptr(), int(dtype == torch.bfloat16), nt, kig, tn,
                                      K, S, _build.stream_ptr(dev))
    _build.check(rc, "gather_dequant_wt")
    _build.KERNELS["gather_dequant_wt"].launches += 1
    return out


def gather_dequant_wt(codes_tl, codebooks, scales, *, dtype=torch.bfloat16):
    """W^T [IN, OUT] in ``dtype`` from tiled codes: each entry
    ``dtype((sum_k f32 cb[k, code, j]) * scale[o])``, as
    ``aqlm_tpu.ops.gather_prefill.gather_dequant_wt``.

    codes_tl: [NT, K*IG, tn] uint8; codebooks: [K, S<=256, g]; scales: [OUT]."""
    if codes_tl.device.type == "cpu":
        return dequant_wt_plain(codes_tl, codebooks, scales, dtype)
    if codes_tl.device.type != "cuda":
        raise ValueError(f"unsupported device {codes_tl.device}")
    return dequant_wt_launch(codes_tl.contiguous(), codebooks.contiguous(), scales.contiguous(),
                             dtype)
