"""Kx8 codebook GEMV for decode (batch <= 8) over the tiled codes layout.

PyTorch counterpart of ``aqlm_tpu.ops.lut_gemv``. On a CUDA tensor every
entry point launches kernel K1 (``csrc/lut_gemv.cu``); on a CPU tensor it
runs the plain version of the same function. The layer-indexed and
fused-projection (grouped) variants are the same kernel with a layer pointer
offset and a per-out-tile projection map.

Tiled codes layout (shared with ``gather_prefill``): ``[NT, IG*K, tn]``,
rows ig-major (row = ig*K + k), NT = OUT / tn.

The all-expert forms ``lut_moe_gemv_kx8`` and ``lut_moe_gemv_kx8_indexed``
run every expert of a Mixtral projection at once and return f32: up to 8
rows in one launch of K1's MoE instance (an expert grid axis), more rows in
one launch of K2's f32 instance (``gather_prefill``, also an expert grid
axis).
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "LUT_GEMV_MAX_BATCH",
    "lut_tile_n",
    "tile_codes",
    "untile_codes",
    "dequant_tiled_t",
    "proj_map_for",
    "lut_gemv_kx8_tiled",
    "lut_gemv_kx8_indexed",
    "lut_gemv_kx8_grouped_indexed",
    "lut_moe_gemv_kx8",
    "lut_moe_gemv_kx8_indexed",
]

LUT_GEMV_MAX_BATCH = 8
_KERNEL_GROUP = 8  # in_group_size the CUDA kernels are written for


def lut_tile_n(out_features: int) -> int:
    """Output-tile width baked into the tiled codes layout."""
    return 512 if out_features % 512 == 0 else 128


def tile_codes(codes_t: torch.Tensor, tn: int | None = None) -> torch.Tensor:
    """[K, IG, OUT] -> [NT, IG*K, tn] (ig-major rows, contiguous tiles)."""
    K, IG, out = codes_t.shape
    if tn is None:
        tn = lut_tile_n(out)
    if out % tn:
        raise ValueError(f"out_features={out} is not a multiple of the tile width {tn}")
    c2 = codes_t.permute(1, 0, 2).reshape(IG * K, out)
    return c2.reshape(IG * K, out // tn, tn).permute(1, 0, 2).contiguous()


def untile_codes(codes_tl: torch.Tensor, num_codebooks: int) -> torch.Tensor:
    """[NT, IG*K, tn] -> [K, IG, OUT]."""
    nt, kig, tn = codes_tl.shape
    c2 = codes_tl.permute(1, 0, 2).reshape(kig, nt * tn)
    return c2.reshape(kig // num_codebooks, num_codebooks, nt * tn).permute(1, 0, 2).contiguous()


def proj_map_for(out_sizes, tn: int, device) -> torch.Tensor:
    """int32 [NT_total]: the projection each out-tile belongs to."""
    pm = []
    for p, sz in enumerate(out_sizes):
        if sz % tn:
            raise ValueError(f"projection width {sz} is not a multiple of the tile width {tn}")
        pm += [p] * (sz // tn)
    return torch.tensor(pm, dtype=torch.int32, device=device)


def dequant_tiled_t(codes_tl: torch.Tensor, codebooks: torch.Tensor,
                    proj_map: torch.Tensor | None = None) -> torch.Tensor:
    """Unscaled W^T ``[IN, OUT]`` f32 from tiled codes.

    codebooks: ``[P, K, S, g]``; tile t reads projection ``proj_map[t]``
    (projection 0 when ``proj_map`` is None)."""
    nt, kig, tn = codes_tl.shape
    P, K, S, g = codebooks.shape
    ig = kig // K
    codes = codes_tl.reshape(nt, ig, K, tn).long()
    p = (torch.zeros(nt, dtype=torch.long, device=codes_tl.device) if proj_map is None
         else proj_map.long())[:, None, None]
    cbf = codebooks.float()
    w = None
    for k in range(K):
        part = cbf[p, k, codes[:, :, k, :]]  # [NT, IG, tn, g]
        w = part if w is None else w + part
    return w.permute(1, 3, 0, 2).reshape(ig * g, nt * tn)


def plain(xb, codes_tl, codebooks, scales, proj_map, out_dtype):
    """K1's plain version on one layer's arrays (same arguments as ``launch``)."""
    wt = dequant_tiled_t(codes_tl, codebooks, proj_map)
    y = torch.matmul(xb.float(), wt) * scales.float()[None, :]
    return y.to(out_dtype)


def launch(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group):
    """K1 on one layer's arrays: xb [B, IN]; codes_tl [NT, K*IG, tn] uint8;
    codebooks [P, K, S, 8] bf16; scales [OUT] f32; proj_map [NT] int32 or None."""
    nt, kig, tn = codes_tl.shape
    P, K, S, g = codebooks.shape
    B, in_features = xb.shape
    dev = xb.device
    if group != _KERNEL_GROUP or g != _KERNEL_GROUP:
        raise NotImplementedError(f"lut_gemv kernel takes in_group_size 8, got {group}")
    if not 1 <= B <= LUT_GEMV_MAX_BATCH:
        raise ValueError(f"lut_gemv kernel takes 1..{LUT_GEMV_MAX_BATCH} rows, got {B}")
    if xb.dtype not in (torch.bfloat16, torch.float32) or out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lut_gemv kernel takes bf16/f32 activations, got {xb.dtype} -> {out_dtype}")
    if codes_tl.dtype != torch.uint8 or codebooks.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("lut_gemv kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if K > 8 or S > 256 or kig % K or in_features != kig // K * g or tn % 128:
        raise ValueError(f"lut_gemv kernel: bad shapes x {tuple(xb.shape)} codes {tuple(codes_tl.shape)} "
                         f"codebooks {tuple(codebooks.shape)}")
    if scales.shape != (nt * tn,):
        raise ValueError(f"scales {tuple(scales.shape)} do not match OUT={nt * tn}")
    if proj_map is not None and (proj_map.dtype != torch.int32 or proj_map.shape != (nt,)):
        raise ValueError("proj_map must be int32 [NT]")
    for t in (xb, codes_tl, codebooks, scales) + (() if proj_map is None else (proj_map,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("lut_gemv kernel operands must be contiguous on one CUDA device")
    if P > 1 and proj_map is None:
        raise ValueError("grouped codebooks need a proj_map")
    if codes_tl.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("lut_gemv kernel needs 16-byte aligned codes and activations")
    out = torch.empty((B, nt * tn), dtype=out_dtype, device=dev)
    # split the input groups of each 128-column group over enough blocks to
    # fill the card twice; the blocks' partial sums meet in `partials`
    col_groups, n_groups = nt * tn // 128, kig // K
    splits = max(1, min(-(-2 * _build.sm_count(dev.index) // col_groups), n_groups // 16))
    splits = -(-n_groups // -(-n_groups // splits))  # no empty split
    partials = tickets = None
    if splits > 1:
        partials = torch.empty((splits, B, nt * tn), dtype=torch.float32, device=dev)
        tickets = torch.zeros(col_groups, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.lut_gemv_launch(
        xb.data_ptr(), codes_tl.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
        None if proj_map is None else proj_map.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        int(xb.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        B, splits, nt, kig, tn, K, S, in_features, _build.stream_ptr(dev),
    )
    _build.check(rc, "lut_gemv")
    _build.KERNELS["lut_gemv"].launches += 1
    return out


def _gemv(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> K1."""
    if xb.device.type == "cpu":
        return plain(xb, codes_tl, codebooks, scales, proj_map, out_dtype)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group)


def lut_gemv_kx8_tiled(x, codes_tl, codebooks, scales, bias=None, *, group: int):
    """y = x @ dequant(codes)^T * scales + bias over the tiled codes layout.

    x: [..., IN] (at most 8 rows); codes_tl: [NT, K*IG, tn] uint8;
    codebooks: [K, S<=256, g]; scales: [OUT]. Output in x's dtype."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    out_dtype = torch.float32 if bias is not None else x.dtype
    y = _gemv(xb, codes_tl, codebooks[None], scales, None, out_dtype, group)
    if bias is not None:
        y = (y + bias[None, :].to(y.dtype)).to(x.dtype)
    return y.reshape(*lead, -1)


def lut_gemv_kx8_indexed(x, codes_tl_all, codebooks_all, scales_all, layer_idx: int,
                         bias_all=None, *, group: int):
    """Layer ``layer_idx`` of stacked params: codes_tl_all [L, NT, K*IG, tn],
    codebooks_all [L, K, S, g], scales_all [L, OUT]."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    out_dtype = torch.float32 if bias_all is not None else x.dtype
    li = int(layer_idx)
    y = _gemv(xb, codes_tl_all[li], codebooks_all[li][None], scales_all[li], None,
              out_dtype, group)
    if bias_all is not None:
        y = (y + bias_all[li][None, :].to(y.dtype)).to(x.dtype)
    return y.reshape(*lead, -1)


def lut_gemv_kx8_grouped_indexed(x, codes_tl_all, codebooks_all, scales_all, out_sizes,
                                 layer_idx: int, *, group: int, proj_map=None):
    """Fused projections (q/k/v or gate/up) of layer ``layer_idx`` in one
    launch: codes_tl_all [L, NT_total, K*IG, tn] concatenates the parts'
    tiles, codebooks_all [L, P, K, S, g] keeps each projection's codebooks,
    scales_all [L, OUT_total]. ``proj_map`` (int32 [NT_total], see
    ``proj_map_for``) may be passed precomputed on the device."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    _, nt, _, tn = codes_tl_all.shape
    if codebooks_all.shape[1] != len(out_sizes) or sum(out_sizes) != nt * tn:
        raise ValueError(f"out_sizes {out_sizes} do not match the fused codes {tuple(codes_tl_all.shape)}")
    if proj_map is None:
        proj_map = proj_map_for(out_sizes, tn, x.device)
    li = int(layer_idx)
    y = _gemv(xb, codes_tl_all[li], codebooks_all[li], scales_all[li], proj_map, x.dtype, group)
    return y.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# all-expert (MoE) form: every expert of one projection, f32 out
# ---------------------------------------------------------------------------


def moe_plain(x, codes_tl_e, codebooks_e, scales_e):
    """The all-expert function's plain version (same arguments as
    ``moe_launch``): y[e] = x_e @ dequant(codes_e)^T * scales_e, the weight
    and the product in f32, as ``aqlm_tpu``'s LUT computes it."""
    E = codes_tl_e.shape[0]
    outs = []
    for e in range(E):
        xe = x[e] if x.dim() == 3 else x
        wt = dequant_tiled_t(codes_tl_e[e], codebooks_e[e][None])
        outs.append(torch.matmul(xe.float(), wt) * scales_e[e].float()[None, :])
    return torch.stack(outs)


def _moe_check(x, codes_tl_e, codebooks_e, scales_e, group):
    E, nt, kig, tn = codes_tl_e.shape
    _, K, S, g = codebooks_e.shape
    if group != _KERNEL_GROUP or g != _KERNEL_GROUP:
        raise NotImplementedError(f"lut_moe_gemv kernel takes in_group_size 8, got {group}")
    if x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != E):
        raise ValueError(f"lut_moe_gemv takes x [N, IN] or [E, N, IN], got {tuple(x.shape)} for E={E}")
    if codebooks_e.shape[:1] != (E,) or scales_e.shape != (E, nt * tn):
        raise ValueError(f"lut_moe_gemv: codebooks {tuple(codebooks_e.shape)} and scales "
                         f"{tuple(scales_e.shape)} do not match codes {tuple(codes_tl_e.shape)}")
    if codes_tl_e.dtype != torch.uint8 or codebooks_e.dtype != torch.bfloat16 \
            or scales_e.dtype != torch.float32:
        raise ValueError("lut_moe_gemv kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if K > 8 or S > 256 or kig % K or x.shape[-1] != kig // K * g or tn % 128:
        raise ValueError(f"lut_moe_gemv kernel: bad shapes x {tuple(x.shape)} codes "
                         f"{tuple(codes_tl_e.shape)} codebooks {tuple(codebooks_e.shape)}")
    for t in (x, codes_tl_e, codebooks_e, scales_e):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("lut_moe_gemv kernel operands must be contiguous on one CUDA device")


def moe_launch(x, codes_tl_e, codebooks_e, scales_e, group):
    """K1's MoE instance, at most 8 rows: x [N, IN] shared or [E, N, IN] per
    expert (bf16 or f32); codes_tl_e [E, NT, K*IG, tn] uint8; codebooks_e
    [E, K, S, 8] bf16; scales_e [E, OUT] f32. Returns f32 [E, N, OUT]."""
    _moe_check(x, codes_tl_e, codebooks_e, scales_e, group)
    E, nt, kig, tn = codes_tl_e.shape
    _, K, S, _ = codebooks_e.shape
    B, in_features = x.shape[-2:]
    dev = x.device
    if not 1 <= B <= LUT_GEMV_MAX_BATCH:
        raise ValueError(f"lut_moe_gemv kernel takes 1..{LUT_GEMV_MAX_BATCH} rows, got {B}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lut_moe_gemv kernel takes bf16/f32 activations, got {x.dtype}")
    if codes_tl_e.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("lut_moe_gemv kernel needs 16-byte aligned codes and activations")
    out = torch.empty((E, B, nt * tn), dtype=torch.float32, device=dev)
    # K1's split rule over E times as many column groups: Mixtral's gate/up
    # (8 x 112 column groups) need no split, its down (8 x 32) two
    col_groups, n_groups = nt * tn // 128, kig // K
    splits = max(1, min(-(-2 * _build.sm_count(dev.index) // (E * col_groups)), n_groups // 16))
    splits = -(-n_groups // -(-n_groups // splits))  # no empty split
    partials = tickets = None
    if splits > 1:  # per expert
        partials = torch.empty((E, splits, B, nt * tn), dtype=torch.float32, device=dev)
        tickets = torch.zeros((E, col_groups), dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.lut_moe_gemv_launch(
        x.data_ptr(), codes_tl_e.data_ptr(), codebooks_e.data_ptr(), scales_e.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), int(x.dtype == torch.bfloat16), B,
        splits, E, B * in_features if x.dim() == 3 else 0, nt, kig, tn, K, S, in_features,
        _build.stream_ptr(dev),
    )
    _build.check(rc, "lut_moe_gemv")
    _build.KERNELS["lut_moe_gemv"].launches += 1
    return out


def moe_prefill_launch(x, codes_tl_e, codebooks_e, scales_e, group):
    """More than 8 rows: K2's f32 instance over every expert in one launch
    (its expert grid axis), each expert writing its slice of the f32
    [E, N, OUT] output (x bf16, shared or per expert). K2 rounds each
    dequantized weight to bf16 before the product; the plain version
    (``moe_plain``) keeps it in f32."""
    from aqlm_tpu_torch.ops import gather_prefill

    _moe_check(x, codes_tl_e, codebooks_e, scales_e, group)
    return gather_prefill.moe_launch(x, codes_tl_e, codebooks_e, scales_e, group)


def lut_moe_gemv_kx8(x, codes_tl_e, codebooks_e, scales_e, *, group: int):
    """All-expert Kx8 codes matmul: y[e] = x @ dequant(codes_e)^T * scales_e.

    x: [N, IN] shared by every expert, or [E, N, IN] one per expert (the
    down projection); codes_tl_e: [E, NT, K*IG, tn] uint8; codebooks_e:
    [E, K, S<=256, g]; scales_e: [E, OUT]. Returns f32 [E, N, OUT]."""
    if x.device.type == "cpu":
        return moe_plain(x, codes_tl_e, codebooks_e, scales_e)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    if x.shape[-2] <= LUT_GEMV_MAX_BATCH:
        return moe_launch(x, codes_tl_e, codebooks_e, scales_e, group)
    return moe_prefill_launch(x, codes_tl_e, codebooks_e, scales_e, group)


def lut_moe_gemv_kx8_indexed(x, codes_tl_le, codebooks_le, scales_le, layer_idx: int, *,
                             group: int):
    """Layer ``layer_idx`` of stacked experts: codes_tl_le [L, E, NT, K*IG,
    tn], codebooks_le [L, E, K, S, g], scales_le [L, E, OUT]; the layer is a
    view (a pointer offset), nothing is copied. Returns f32 [E, N, OUT]."""
    li = int(layer_idx)
    return lut_moe_gemv_kx8(x, codes_tl_le[li], codebooks_le[li], scales_le[li], group=group)
