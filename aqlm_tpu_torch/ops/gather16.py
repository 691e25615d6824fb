"""Codes-resident matmul for 16-bit codebooks (1x16 schemes).

PyTorch counterpart of ``aqlm_tpu.ops.gather16``. One codebook of 65536
entries of ``g`` (8 or 16) values serves a projection; the codes are
``[OUT, IG]``, two bytes each, stored as int16 holding the uint16 bits (a
code of 40000 reads as -25536 and is taken unsigned everywhere). The
codebook is kept as ``aqlm_tpu`` keeps it, packed into ``[S*g/128, 128]``
bf16 rows, byte for byte the ``[S, g]`` table.

On a CUDA tensor ``gather_matmul_16`` launches the hand-written kernels of
``csrc/gather16.cu``, laid out by the pure ``plan``: a GEMV for at most 8
rows; for more (bf16 activations) a gather pre-pass that writes the bf16 W
once into a transient buffer, then a TMA + wgmma GEMM over it. On a CPU
tensor it runs the plain version of the same function. Rounding follows
``aqlm_tpu``: the weight is the bf16 codebook entry (exact), the product
accumulates in f32, the scales multiply the f32 sum, which rounds once to
the activations' type, and a bias is added after that in the same type.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "GATHER16_GEMV_MAX_BATCH",
    "SMEM_LIMIT",
    "Plan",
    "plan",
    "codes16",
    "pack_codebook_rows",
    "dequantize_gather16",
    "gather_matmul_16",
    "gather_matmul_16_indexed",
]

GATHER16_GEMV_MAX_BATCH = 8
_KERNEL_GROUPS = (8, 16)  # in_group_size the CUDA kernels are written for
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
_SM_SMEM = 233472  # shared memory of one SM (228 KB), 1 KB of it reserved per block
# the GEMV's warps a block (one output row each at a time: the first design,
# and the g=16 lane-pair kernel with its blocks an SM and rows at most); the
# GEMM's column tile and slab width, ring depth per block height, the
# pre-pass's threads and units a thread; the planner's time model of one
# block-slab (us) and of the split partials' bytes
_V_WARPS = 16
_P2_WARPS, _P2_BLOCKS_PER_SM, _P2_MAX_ROWS = 8, 2, 4
_BN, _BK = 128, 64
_STAGES = {128: 6, 256: 4}
_P_THREADS, _P_UNROLL = 256, 8
_SLAB_US = {128: 0.3, 256: 0.55}
_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of B1. ``gemv`` (<= 8 rows): ``grid`` (blocks,), x staged
    in ``smem`` bytes of shared memory when ``x_staged``. ``gemm``: the
    pre-pass gathers each weight once (``prepass_blocks`` blocks; its bf16 W,
    ``scratch_bytes``, is transient), then the GEMM runs ``bm`` rows a block,
    a ring of ``stages``, the input split over ``splits`` runs of
    ``per_split`` 64-wide slabs, on ``grid`` (column tiles, row tiles,
    splits) with ``smem`` bytes, which the kernel checks against its own
    layout. ``gathers_per_weight``: L2 gathers of each weight in one launch
    (no 2-CTA cluster is built: the pre-pass gathers once)."""

    path: str
    bm: int
    stages: int
    splits: int
    per_split: int
    grid: tuple
    smem: int
    x_staged: bool
    prepass_blocks: int
    scratch_bytes: int
    gathers_per_weight: int

    def partials_shape(self, T: int, out_features: int):
        """The GEMM's f32 split partial sums, None when unsplit."""
        if self.path != "gemm" or self.splits == 1:
            return None
        return (self.splits, self.grid[1] * self.bm, out_features)


def gemv_smem(B: int, ig: int, group: int, x_bytes: int) -> int:
    """The g=16 GEMV's staged x: B rows of IN activations in 16-byte units,
    one pad unit after every 8 * (x_bytes / 2) (the kernel's ``x_unit``)."""
    units = ig * group * x_bytes // 16
    return B * (units + units // (4 * x_bytes)) * 16


def gemm_smem(bm: int, stages: int) -> int:
    """The GEMM's dynamic shared memory (the kernel's ``MLayout``): per stage
    the x tile [bm x 64] and the W tile [128 x 64] in bf16, the stage
    barriers, the split flag, 1024 bytes of alignment slack."""
    return stages * (bm + _BN) * _BK * 2 + 2 * stages * 8 + 16 + 1024


def plan(T: int, out_features: int, ig: int, g: int, sm_count: int = 132,
         x_dtype=torch.bfloat16) -> Plan:
    """B1's launch, a pure function of the shapes. At <= 8 rows the GEMV: at
    g=8, and at g=16 past 4 rows, the first design (16 rows a block, x
    staged 256 codes at a time); at g=16 and 1-4 rows the lane-pair kernel
    (8 warps a block, two rows each at once), x (bf16 or f32) staged per
    block where it fits in SMEM_LIMIT, as many blocks as the SMs hold (at
    most 2 an SM, fewer as the staged x grows) and no more than the rows
    need. Past 8 rows (bf16 x) the pre-pass and the GEMM: 256 rows a block
    past 128 rows, else 128; the input split only where the output tiles
    leave SMs idle and the time model (waves x slabs a block, plus the
    partial sums' bytes) says it pays."""
    if g not in _KERNEL_GROUPS or ig < 8 or ig % 8 or T < 1 or out_features < 1 or sm_count < 1:
        raise ValueError(f"gather16 kernels: no plan for T={T} OUT={out_features} IG={ig} g={g}")
    if T <= GATHER16_GEMV_MAX_BATCH:
        if x_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"gather16 GEMV takes bf16/f32 activations, got {x_dtype}")
        x_bytes = 2 if x_dtype == torch.bfloat16 else 4
        if g == 8 or T > _P2_MAX_ROWS:  # the first design: 16 rows a block, x a chunk at a time
            return Plan("gemv", 0, 0, 1, ig // 8, (-(-out_features // _V_WARPS),),
                        T * 32 * (8 * (g * x_bytes // 16) + 1) * 16, True, 0, 0, 1)
        smem = gemv_smem(T, ig, g, x_bytes)
        staged = smem <= SMEM_LIMIT
        smem = smem if staged else 0
        per_sm = (max(1, min(_P2_BLOCKS_PER_SM, _SM_SMEM // (smem + 1024))) if staged
                  else _P2_BLOCKS_PER_SM)
        blocks = min(-(-out_features // (2 * _P2_WARPS)), sm_count * per_sm)  # two rows a warp
        return Plan("gemv", 0, 0, 1, ig // 8, (blocks,), smem, staged, 0, 0, 1)
    if x_dtype != torch.bfloat16:
        raise ValueError(f"gather16 GEMM takes bf16 activations, got {x_dtype}")
    bm = 128 if T <= 128 else 256
    stages = _STAGES[bm]
    in_features = ig * g
    col_tiles, row_tiles, n_slabs = -(-out_features // _BN), -(-T // bm), in_features // _BK
    tiles = col_tiles * row_tiles

    def cost(s):
        waves = -(-tiles * s // sm_count)
        part = 0 if s == 1 else 8 * s * row_tiles * bm * out_features / _BYTES_PER_US
        return waves * -(-n_slabs // s) * _SLAB_US[bm] + part

    splits = 1
    if tiles < sm_count:
        splits = min(range(1, max(1, min(16, n_slabs // 4)) + 1), key=cost)
    per_split = -(-n_slabs // splits)
    splits = -(-n_slabs // per_split)  # no empty split
    n_units = out_features * ig * g // 8
    prepass_blocks = max(1, min(-(-n_units // (_P_THREADS * _P_UNROLL)), 8 * sm_count))
    return Plan("gemm", bm, stages, splits, per_split, (col_tiles, row_tiles, splits),
                gemm_smem(bm, stages), False, prepass_blocks, out_features * in_features * 2, 1)


def codes16(codes: torch.Tensor) -> torch.Tensor:
    """uint16 codes as int16 with the same bits (int16 ones as they are)."""
    if codes.dtype == torch.int16:
        return codes
    if codes.dtype != torch.uint16:
        raise ValueError(f"16-bit codes are uint16 or int16, got {codes.dtype}")
    return codes.view(torch.int16).contiguous()


def pack_codebook_rows(codebook: torch.Tensor, group: int) -> torch.Tensor:
    """[S, group] -> [S*group/128, 128] row-packed bf16 table."""
    s = codebook.shape[0]
    if s % (128 // group):
        raise ValueError(f"{s} codebook entries do not fill 128-wide rows of group {group}")
    return codebook.reshape(s * group // 128, 128).to(torch.bfloat16)


def _weight(codes: torch.Tensor, packed_cb: torch.Tensor, group: int) -> torch.Tensor:
    """Unscaled W [OUT, IN] in the codebook's type: row ``code`` of the
    [S, g] view of the packed table for each group."""
    out_features, ig = codes.shape
    table = packed_cb.reshape(-1, group)
    return table[codes.long() & 0xFFFF].reshape(out_features, ig * group)


def dequantize_gather16(codes, packed_cb, scales, *, group: int) -> torch.Tensor:
    """Dense W [OUT, IN] from 16-bit codes: the bf16 weight times the scales
    rounded to bf16, in bf16, as ``aqlm_tpu`` computes it."""
    w = _weight(codes, packed_cb, group)
    return w * scales[:, None].to(w.dtype)


def plain(xb, codes, packed_cb, scales, group):
    """The kernels' plain version: xb [N, IN] -> [N, OUT] in xb's type."""
    w = _weight(codes, packed_cb, group).float()
    y = torch.matmul(xb.float(), w.t()) * scales.float()[None, :]
    return y.to(xb.dtype)


def _check(xb, codes, packed_cb, scales, group):
    out_features, ig = codes.shape
    dev = xb.device
    if group not in _KERNEL_GROUPS:
        raise NotImplementedError(f"gather16 kernels take in_group_size 8 or 16, got {group}")
    if ig % 8:
        raise NotImplementedError(f"gather16 kernels read 8 codes at once: {ig} input groups "
                                  "is not a multiple of 8")
    if xb.shape[1] != ig * group:
        raise ValueError(f"gather16: x {tuple(xb.shape)} does not match codes {tuple(codes.shape)} "
                         f"at group {group}")
    if codes.dtype != torch.int16 or packed_cb.dtype != torch.bfloat16 or scales.dtype != torch.float32:
        raise ValueError("gather16 kernels take int16 codes, a bf16 codebook and f32 scales")
    if packed_cb.numel() != 65536 * group or scales.shape != (out_features,):
        raise ValueError(f"gather16: codebook {tuple(packed_cb.shape)} or scales "
                         f"{tuple(scales.shape)} do not match codes {tuple(codes.shape)}")
    for t in (xb, codes, packed_cb, scales):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gather16 kernel operands must be contiguous on one CUDA device")
    if codes.data_ptr() % 16 or xb.data_ptr() % 16 or packed_cb.data_ptr() % 16:
        raise ValueError("gather16 kernels need 16-byte aligned codes, codebook and activations")


def gemv_launch(xb, codes, packed_cb, scales, group):
    """The GEMV kernel: xb [B <= 8, IN] bf16 or f32 -> [B, OUT] in xb's type."""
    _check(xb, codes, packed_cb, scales, group)
    B = xb.shape[0]
    if not 1 <= B <= GATHER16_GEMV_MAX_BATCH:
        raise ValueError(f"gather16 GEMV takes 1..{GATHER16_GEMV_MAX_BATCH} rows, got {B}")
    if xb.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather16 GEMV takes bf16/f32 activations, got {xb.dtype}")
    out_features, ig = codes.shape
    p = plan(B, out_features, ig, group, _build.sm_count(xb.device.index), xb.dtype)
    out = torch.empty((B, out_features), dtype=xb.dtype, device=xb.device)
    lib, _ = _build.library()
    rc = lib.gather16_gemv_launch(xb.data_ptr(), codes.data_ptr(), packed_cb.data_ptr(),
                                  scales.data_ptr(), out.data_ptr(), int(xb.dtype == torch.bfloat16),
                                  B, out_features, ig, group, int(p.x_staged), p.grid[0], p.smem,
                                  _build.stream_ptr(xb.device))
    _build.check(rc, "gather16_gemv")
    _build.count("gather16_gemv")
    return out


def gather_w(codes, packed_cb, group, blocks=None):
    """The GEMM's pre-pass on the card: the unscaled bf16 W [OUT, IN] =
    codebook rows at the codes, gathered once into a fresh tensor."""
    out_features, ig = codes.shape
    dev = codes.device
    w = torch.empty((out_features, ig * group), dtype=torch.bfloat16, device=dev)
    n_codes = out_features * ig
    if blocks is None:
        p = plan(GATHER16_GEMV_MAX_BATCH + 1, out_features, ig, group, _build.sm_count(dev.index))
        blocks = p.prepass_blocks
    lib, _ = _build.library()
    rc = lib.gather16_wt_launch(codes.data_ptr(), packed_cb.data_ptr(), w.data_ptr(), n_codes, group,
                                blocks, _build.stream_ptr(dev))
    _build.check(rc, "gather16_wt")
    return w


def gemm_w_launch(xb, w, scales, p):
    """The GEMM proper as ``p`` (a ``plan``) lays it out: xb [T, IN] bf16
    times the gathered w [OUT, IN] bf16 -> [T, OUT] bf16."""
    T, in_features = xb.shape
    out_features = w.shape[0]
    dev = xb.device
    out = torch.empty((T, out_features), dtype=torch.bfloat16, device=dev)
    partials = tickets = None
    if p.splits > 1:
        partials = torch.empty(p.partials_shape(T, out_features), dtype=torch.float32, device=dev)
        tickets = torch.zeros(p.grid[0] * p.grid[1], dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.gather16_gemm_launch(
        xb.data_ptr(), w.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        T, out_features, in_features, p.bm, p.stages, p.smem, p.splits, p.per_split,
        _build.stream_ptr(dev))
    _build.check(rc, "gather16_gemm")
    return out


def gemm_launch(xb, codes, packed_cb, scales, group):
    """The GEMM: xb [T, IN] bf16 -> [T, OUT] bf16, by the gather pre-pass
    (W [OUT, IN] bf16, transient) and the TMA + wgmma GEMM over it."""
    _check(xb, codes, packed_cb, scales, group)
    if xb.dtype != torch.bfloat16:
        raise ValueError(f"gather16 GEMM takes bf16 activations, got {xb.dtype}")
    T = xb.shape[0]
    out_features, ig = codes.shape
    if T == 0:
        return torch.empty((0, out_features), dtype=torch.bfloat16, device=xb.device)
    p = plan(T, out_features, ig, group, _build.sm_count(xb.device.index))
    w = gather_w(codes, packed_cb, group, p.prepass_blocks)
    out = gemm_w_launch(xb, w, scales, p)
    _build.count("gather16_gemm")
    return out


def _matmul(xb, codes, packed_cb, scales, group):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> the
    GEMV (<= 8 rows) or the GEMM."""
    if xb.device.type == "cpu":
        return plain(xb, codes, packed_cb, scales, group)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    if xb.shape[0] <= GATHER16_GEMV_MAX_BATCH:
        return gemv_launch(xb, codes, packed_cb, scales, group)
    return gemm_launch(xb, codes, packed_cb, scales, group)


def gather_matmul_16(x, codes, packed_cb, scales, bias=None, *, group: int):
    """y = (x @ dequant(codes)^T) * scales + bias; W never persists.

    x: [..., IN]; codes: [OUT, IG] int16 (uint16 bits); packed_cb:
    [65536*g/128, 128] bf16; scales: [OUT] f32; bias: [OUT] or None.
    Output in x's dtype; the bias is added in that dtype."""
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    y = _matmul(xb, codes, packed_cb, scales, group)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.reshape(*lead, -1)


def gather_matmul_16_indexed(x, codes_all, packed_all, scales_all, layer_idx: int,
                             bias_all=None, *, group: int):
    """Layer ``layer_idx`` of stacked params ([L, ...] leaves): each operand
    is a view of that layer, nothing is copied."""
    li = int(layer_idx)
    return gather_matmul_16(x, codes_all[li], packed_all[li], scales_all[li],
                            None if bias_all is None else bias_all[li], group=group)
