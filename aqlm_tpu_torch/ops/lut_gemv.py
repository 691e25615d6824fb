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

import dataclasses
import math

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "LUT_GEMV_MAX_BATCH",
    "SMEM_LIMIT",
    "Plan",
    "plan",
    "smem_bytes",
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
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
# K1's shape (csrc/lut_gemv.cu): a chunk is two (group block, codebook)
# pairs whose tables fill 256 rows of 32 floats; code rows padded
_PAIRS, _ROW_FLOATS, _CODE_PAD, _MAX_STAGES = 2, 32, 16, 6
_TABLE_BYTES = 256 * _ROW_FLOATS * 4
_TWO_BLOCKS = 115712  # shared memory a block may take so that two share an SM
_MIN_CHUNKS = 4  # chunks a split walks at least
_THREADS = 256  # a block's threads (two blocks an SM)
_BLOCK_CHUNKS = 4  # a block's fixed part (first build, sums, split reduction) in chunks


def batch_pad(rows: int) -> int:
    """The rows K1 computes for ``rows`` rows of x: 1, 2, 4 or 8."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def smem_bytes(cols: int, bp: int, stages: int, K: int) -> int:
    """K1's dynamic shared memory (the kernel's ``smem_bytes``): two chunks'
    tables, the code ring (a chunk's 2 * 16 / bp code rows of cols + 16
    bytes a stage), the block's K codebooks (256 rows of 16 bytes each) and
    the split path's flag."""
    return (2 * _TABLE_BYTES + stages * (_PAIRS * 16 // bp) * (cols + _CODE_PAD) + K * 256 * 16
            + 16)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One K1 launch: output columns a block (``cols``), the projections'
    width (``proj_width``, ``blocks_per_proj`` blocks each, the last cut at
    its end), rows computed (``bp``), a lane's code reads
    (``colvec`` codes at once, ``vectors`` of them), groups of a group block
    and tables of a chunk, code-ring stages, blocks along the input groups
    (``splits`` of ``gb_per_split`` group blocks each), the grid (column
    blocks, splits, experts) and the dynamic shared memory, which the kernel
    checks against its own layout."""

    cols: int
    proj_width: int
    blocks_per_proj: int
    bp: int
    colvec: int
    vectors: int
    group_block: int
    tables: int
    stages: int
    splits: int
    gb_per_split: int
    grid: tuple
    smem: int

    @property
    def lookup_floats(self) -> int:
        """f32 values of one lookup (an entry is ``bp`` values, read in halves at bp 8)."""
        return min(self.bp, 4)

    @property
    def phase_lanes(self) -> int:
        """Lanes of one shared-memory phase of a lookup (128 bytes)."""
        return 32 // self.lookup_floats

    def lookup_lane(self, lane: int) -> tuple:
        """(table, float of a table row) that ``lane`` reads in every lookup,
        and its code vectors' first columns over the block's warps; the
        kernel's lane map."""
        bh, P, warps = self.lookup_floats, self.phase_lanes, _THREADS // 32
        ts, h = (lane % P) % self.tables, (lane % P) // self.tables
        cs = lane // P
        first = [(w * (32 // P) + cs + j * (warps * 32 // P)) * self.colvec
                 for w in range(warps) for j in range(self.vectors)]
        return ts, ts * self.bp + h * bh, first

    def block_columns(self, bx: int) -> range:
        """The output columns block ``bx`` writes."""
        p0 = bx // self.blocks_per_proj * self.proj_width
        c0 = p0 + bx % self.blocks_per_proj * self.cols
        return range(c0, min(c0 + self.cols, p0 + self.proj_width))


def plan(B: int, K: int, out_features: int, n_groups: int, tn: int, P: int = 1, experts: int = 1,
         sm_count: int = 132, proj_cols: int | None = None) -> Plan:
    """Columns, stages, splits, grid and shared memory of one K1 launch, a
    pure function of the shapes. ``P`` projections share the codes, of
    ``proj_cols`` columns each where they are equal (else their common
    divisor, a tile ``tn`` when not given, is the width blocks keep within).
    Each table serves a block's columns, so wider blocks amortise its build:
    512 columns where the width allows, else 256; a projection's last block
    is cut at its end. The input groups are split over blocks where that
    shortens waves x (a block's chunks + a fixed part of four), each split
    walking at least four chunks."""
    if not 1 <= B <= LUT_GEMV_MAX_BATCH or not 1 <= K <= 8 or out_features % 128 or tn % 128 \
            or n_groups < 1 or experts < 1 or P < 1:
        raise ValueError(f"lut_gemv kernel: no plan for B={B} K={K} OUT={out_features} "
                         f"IG={n_groups} tn={tn} P={P} E={experts}")
    if P == 1:
        width = out_features
    elif proj_cols and proj_cols * P == out_features and proj_cols % 128 == 0:
        width = proj_cols
    else:
        width = math.gcd(proj_cols or tn, out_features)
    cols = 512 if width >= 512 else 256
    bp = batch_pad(B)
    lanes = 32 // min(bp, 4)
    cv = cols * lanes // _THREADS
    colvec = min(cv, 16)
    gbs = 16 // bp
    n_gb = -(-n_groups // gbs)
    col_blocks = experts * out_features // width * -(-width // cols)
    slots = 2 * sm_count
    most = max(1, n_gb * K // (_PAIRS * _MIN_CHUNKS))

    def cost(s):  # waves x (a block's chunks + its fixed part); ties go to fewer splits
        gb = -(-n_gb // s)  # group blocks a split
        chunks = -(-gb * K // _PAIRS)
        return -(-col_blocks * s // slots) * (chunks + _BLOCK_CHUNKS), s

    splits = min(range(1, most + 1), key=cost)
    gb_per_split = -(-n_gb // splits)
    splits = -(-n_gb // gb_per_split)  # no empty split
    fits = [st for st in range(_MAX_STAGES, 1, -1) if smem_bytes(cols, bp, st, K) <= _TWO_BLOCKS]
    stages = fits[0] if fits else 2
    return Plan(cols, width, -(-width // cols), bp, colvec, cv // colvec, gbs,
                _PAIRS * gbs, stages, splits, gb_per_split, (col_blocks // experts, splits, experts),
                smem_bytes(cols, bp, stages, K))


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


def launch(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group, *, proj_cols=None,
           form="unindexed"):
    """K1 on one layer's arrays: xb [B, IN]; codes_tl [NT, K*IG, tn] uint8;
    codebooks [P, K, S, 8] bf16; scales [OUT] f32; proj_map [NT] int32 or
    None; ``proj_cols`` the projections' common width (their gcd), which lets
    a block span tiles (one tile when not given); ``form`` is the wrapper's,
    for the launch count."""
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
    p = plan(B, K, nt * tn, kig // K, tn, P, 1, _build.sm_count(dev.index), proj_cols)
    _launch(p, xb, codes_tl, codebooks, scales, proj_map, out, 0, 1, K, S, "lut_gemv", form)
    return out


def _launch(p, x, codes, codebooks, scales, proj_map, out, moe, experts, K, S, counter,
            form=None):
    """One launch of K1 as ``p`` lays it out (dense or all-expert)."""
    nt, kig, tn = codes.shape[-3:]
    B, in_features = x.shape[-2:]
    dev = x.device
    partials = tickets = None
    if p.splits > 1:  # per expert; the last block of each column block adds them in order
        lead = (experts,) if moe else ()
        partials = torch.empty(lead + (p.splits, B, nt * tn), dtype=torch.float32, device=dev)
        tickets = torch.zeros(lead + (p.grid[0],), dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.lut_gemv_launch(
        x.data_ptr(), codes.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
        None if proj_map is None else proj_map.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        int(x.dtype == torch.float32), int(out.dtype == torch.float32), B, p.cols, p.splits,
        p.gb_per_split, p.stages, p.smem, moe, experts,
        B * in_features if x.dim() == 3 else 0, nt, kig, tn, K, S, in_features, p.proj_width,
        p.blocks_per_proj, _build.stream_ptr(dev),
    )
    _build.check(rc, counter)
    _build.count(counter, form)


def _gemv(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group, proj_cols=None,
          form="unindexed"):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> K1."""
    if xb.device.type == "cpu":
        return plain(xb, codes_tl, codebooks, scales, proj_map, out_dtype)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, codes_tl, codebooks, scales, proj_map, out_dtype, group, proj_cols=proj_cols,
                  form=form)


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
              out_dtype, group, form="indexed")
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
    y = _gemv(xb, codes_tl_all[li], codebooks_all[li], scales_all[li], proj_map, x.dtype, group,
              math.gcd(*out_sizes), form="indexed")
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
    p = plan(B, K, nt * tn, kig // K, tn, 1, E, _build.sm_count(dev.index))
    _launch(p, x, codes_tl_e, codebooks_e, scales_e, None, out, 1, E, K, S, "lut_moe_gemv")
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
