"""W8A16 matmul: int8 weights widened on chip, each weight byte read once.

PyTorch counterpart of ``aqlm_tpu.ops.int8_matmul`` (``int8_matmul``,
``int8_matmul_indexed``, the all-expert MoE forms ``int8_moe_matmul`` and
``int8_moe_matmul_indexed``, and the activation backward
``int8_matmul_transposed``). On a CUDA tensor every entry point launches a
kernel of ``csrc/int8_matmul.cu``; on a CPU tensor it runs the plain version
of the same function. The layer-indexed variants are the same kernel with a
layer pointer offset; the MoE forms run every expert in one launch, the
expert being one more tile coordinate (GEMV) or grid axis (GEMM) of the
same kernel. The pure ``plan`` lays each launch out: at <= 8 rows a GEMV
split over no blocks (a ``GemvPlan``: a CUDA-core row kernel at 1-2 rows, a
tensor-core GEMV at 3-8), and past them a warp-specialised TMA + wgmma GEMM
(a ``Plan``). The backward (the contraction runs over w8's rows) has
kernels of its own, laid out by the pure ``plan_t``: a column GEMV at <= 8
rows, and past them a bf16(g * scale) pass followed by a GEMM of the same
shape.

Layout (shared with ``aqlm_tpu``, so weights and checkpoints carry across):
``w8`` is ``[OUT, IN_pad]`` int8, rows contiguous along the contraction dim,
``IN_pad = pad_in_features(IN)`` with zero columns past ``IN``;
``w_scale`` is ``[OUT]`` f32. The kernel reads only the first ``IN`` columns
of each row, so activations are never padded.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "IN_PAD_MULTIPLE",
    "INT8_GEMV_MAX_ROWS",
    "GEMV_ROWS_MAX_ROWS",
    "pad_in_features",
    "quantize_int8",
    "int8_matmul",
    "int8_matmul_indexed",
    "int8_moe_matmul",
    "int8_moe_matmul_indexed",
    "int8_matmul_transposed",
    "Plan",
    "GemvPlan",
    "plan",
    "gemv_layout",
    "PlanT",
    "plan_t",
]

IN_PAD_MULTIPLE = 1024  # weight rows padded so large contraction tiles divide evenly
INT8_GEMV_MAX_ROWS = 8  # up to this many rows take the kernel's decode path
GEMV_ROWS_MAX_ROWS = 2  # up to this many the decode path is the CUDA-core row kernel
# the forward's shapes (csrc/int8_matmul.cu): the GEMV's rows a tile, its
# warps a block and their sums' shared memory, the contraction unit its
# warps' pieces are made of, and each warp's ring of 16 x 128-byte weight
# items; the GEMM's 128-channel tile, 64-column slabs and ring depth at each
# block height, and the planner's time model of one block-slab (us; at 64
# rows two blocks share an SM)
_GEMV_ROWS, _GEMV_WARPS, _GEMV_UNIT, _GEMV_STAGES, _GEMV_ITEM = 16, 16, 64, 2, 256
_GEMV_RED = _GEMV_WARPS * _GEMV_ROWS * 8 * 4
_GEMV_RING = _GEMV_WARPS * _GEMV_STAGES * _GEMV_ROWS * _GEMV_ITEM
_GEMM_BN, _GEMM_BK = 128, 64
_GEMM_STAGES = {64: 4, 128: 6, 256: 4}
_GEMM_SLAB_US = {64: 0.35, 128: 0.35, 256: 0.55}
TWO_BLOCKS_SMEM = 115712  # dynamic shared memory at which two blocks still share an SM


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


def moe_plain(xb, w8, w_scale):
    """The MoE kernel's plain version (same arguments as ``moe_launch``): per
    expert, the f32 product of its activations (xb [rows, IN] shared, or xb
    [E, rows, IN]) and its widened weights, times its scales, cast to x's
    dtype. Returns [E, rows, OUT]."""
    w = w8[..., : xb.shape[-1]].float()
    y = torch.matmul(xb.float(), w.transpose(1, 2)) * w_scale.float()[:, None, :]
    return y.to(xb.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a prefill GEMM (int8's, and int4's ``plan`` past 8
    rows): the rows a block (``bm``) and ring stages, the contraction split
    over ``splits`` runs of ``per_split`` columns (whole units of the
    kernel's contraction: int8 64, int4 256), the grid and the dynamic
    shared memory, which the kernel checks against its own layout."""

    bm: int
    stages: int
    splits: int
    per_split: int
    grid: tuple
    smem: int

    def partials_shape(self, T: int, out_features: int, experts: int = 1):
        """The f32 split partial sums' shape, None when unsplit."""
        if self.splits == 1:
            return None
        return (experts, self.splits, self.grid[1] * self.bm, out_features)

    def n_tickets(self, experts: int = 1) -> int:
        """The split path's tickets: one per output tile."""
        return experts * self.grid[0] * self.grid[1]


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """One launch of a decode GEMV (int8's and int4's, <= 8 rows), split
    over no blocks. ``form`` ``mma``, the tensor-core GEMV: ``blocks``
    blocks, each walking a contiguous run of 16-row tiles over the whole
    contraction, the activations staged in shared memory in ``runs`` runs,
    and the dynamic shared memory (``gemv_layout`` of the kernel's module),
    which the kernel checks. ``form`` ``rows`` (int8 at 1-2 rows), the
    CUDA-core row kernel: a block a 16-row tile (``blocks`` = tiles), static
    shared memory (``runs`` and ``smem`` 0)."""

    blocks: int
    runs: int
    smem: int
    form: str = "mma"


def gemv_layout(T: int, in_features: int, tiles: int, blocks: int) -> tuple[int, int]:
    """(runs, shared memory) of the GEMV (the kernel's ``GemvLayout``): two
    buffers of the warps' sums of a tile; each tile's sums kept between runs
    where there are several; each warp's barrier; each warp's ring of weight
    items; then each warp's own activation columns, T rows of its largest
    piece (the contraction's 64-column units dealt into 16 x runs contiguous
    pieces) and 16 bytes, so that a phase's rows start 16 bytes apart from
    bank to bank. One run where the whole contraction fits, else the fewest
    that fit."""
    n_units = -(-in_features // _GEMV_UNIT)
    run = -(-tiles // blocks)  # the most tiles a block walks
    chunks = 1
    while True:
        pieces = _GEMV_WARPS * chunks
        piece = -(-n_units // pieces) * _GEMV_UNIT
        park = run * _GEMV_ROWS * 8 * 4 if chunks > 1 else 0
        total = 2 * _GEMV_RED + park + _GEMV_RING + _GEMV_WARPS * (8 + T * (2 * piece + 16))
        if total <= T_SMEM_LIMIT or n_units <= pieces:
            return chunks, total
        chunks += 1


def plan(T: int, out_features: int, in_features: int, ld: int, experts: int = 1,
         sm_count: int = 132) -> Plan | GemvPlan:
    """One forward launch, a pure function of the shapes. At 1-2 rows the
    row kernel's ``GemvPlan`` (a block a 16-row tile); at 3-8 the
    tensor-core GEMV's: one block an SM (or one a 16-row tile, where there
    are fewer tiles) walking a contiguous run of tiles, each over the whole
    contraction (no split over blocks). Past 8 rows the GEMM's ``Plan``: 256
    rows a block past 256 rows, 128 past 64, else 64 (two blocks an SM); the
    contraction split only where the output tiles leave SMs idle and the
    time model (waves x slabs a block, plus the partial sums' bytes) says it
    pays."""
    if (T < 1 or experts < 1 or out_features < 1 or in_features < 16 or in_features % 16
            or ld % 16 or in_features > ld):
        raise ValueError(f"int8_matmul kernel: no plan for T={T} OUT={out_features} "
                         f"IN={in_features} ld={ld} E={experts} (IN <= ld, both multiples of 16)")
    if T <= GEMV_ROWS_MAX_ROWS:
        return GemvPlan(experts * -(-out_features // _GEMV_ROWS), 0, 0, "rows")
    if T <= INT8_GEMV_MAX_ROWS:
        tiles = experts * -(-out_features // _GEMV_ROWS)
        blocks = min(tiles, sm_count)
        return GemvPlan(blocks, *gemv_layout(T, in_features, tiles, blocks))
    bm = 64 if T <= 64 else 128 if T <= 256 else 256
    stages = _GEMM_STAGES[bm]
    col_tiles, row_tiles = -(-out_features // _GEMM_BN), -(-T // bm)
    n_slabs = -(-in_features // _GEMM_BK)
    tiles = experts * col_tiles * row_tiles
    slots = sm_count * (2 if bm == 64 else 1)

    def cost(s):
        waves = -(-tiles * s // slots)
        part = 0 if s == 1 else 8 * s * experts * row_tiles * bm * out_features / _BYTES_PER_US
        return waves * -(-n_slabs // s) * _GEMM_SLAB_US[bm] + part

    splits = 1
    if tiles < slots:
        splits = min(range(1, max(1, min(16, n_slabs // 4)) + 1), key=cost)
    per_split = -(-n_slabs // splits)
    splits = -(-n_slabs // per_split)  # no empty split
    return Plan(bm, stages, splits, per_split * _GEMM_BK,
                (col_tiles, row_tiles, experts * splits), gemm_t_smem(bm, stages))


def _run(xb, w8, w_scale, name, x_per_expert, form=None):
    """Check the operands of one launch (w8 [E, OUT, IN_pad], w_scale [E,
    OUT], xb [rows, IN] or [E, rows, IN]) and launch it as ``plan`` lays it
    out. Returns [E, rows, OUT] bf16."""
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
    p = plan(rows, out_features, in_features, ld, experts, _build.sm_count(dev.index))
    lib, _ = _build.library()
    if isinstance(p, GemvPlan):
        rc = lib.int8_gemv_launch(
            xb.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), out.data_ptr(), experts,
            int(x_per_expert), rows, out_features, in_features, ld, p.blocks, p.runs, p.smem,
            _build.stream_ptr(dev),
        )
    else:
        partials = tickets = None
        if p.splits > 1:
            # each expert's splits' f32 partial sums meet here; the last block of
            # each output tile to finish adds them in a fixed order and zeroes
            # its ticket again
            partials = torch.empty(p.partials_shape(rows, out_features, experts),
                                   dtype=torch.float32, device=dev)
            tickets = _build.tickets(dev, p.n_tickets(experts))
        rc = lib.int8_matmul_launch(
            xb.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            experts, int(x_per_expert), rows, p.splits, p.per_split, out_features, in_features,
            ld, p.bm, p.stages, p.smem, _build.stream_ptr(dev),
        )
    _build.check(rc, name)
    _build.count(name, form)
    return out


def launch(xb, w8, w_scale, form="unindexed"):
    """The kernel on one layer's arrays: xb [rows, IN] bf16; w8 [OUT, IN_pad]
    int8; w_scale [OUT] f32. Rows <= 8 take the decode (GEMV) path, more
    rows the prefill (TMA + wgmma GEMM) path. Returns [rows, OUT] bf16."""
    if w8.dim() != 2 or w_scale.dim() != 1:
        raise ValueError(f"int8_matmul kernel takes w8 [OUT, IN_pad] and w_scale [OUT], got "
                         f"{tuple(w8.shape)} and {tuple(w_scale.shape)}")
    return _run(xb, w8[None], w_scale[None], "int8_matmul", False, form)[0]


def moe_launch(xb, w8, w_scale):
    """The kernel over every expert of one layer in one launch: xb [rows, IN]
    bf16 (shared by the experts) or [E, rows, IN] (one slab per expert); w8
    [E, OUT, IN_pad] int8; w_scale [E, OUT] f32. Returns [E, rows, OUT] bf16."""
    if w8.dim() != 3 or xb.dim() not in (2, 3):
        raise ValueError(f"int8_moe_matmul kernel takes w8 [E, OUT, IN_pad] and x [rows, IN] or "
                         f"[E, rows, IN], got {tuple(w8.shape)} and {tuple(xb.shape)}")
    return _run(xb, w8, w_scale, "int8_moe_matmul", xb.dim() == 3)


def _matmul(xb, w8, w_scale, form="unindexed"):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> the kernel."""
    if xb.device.type == "cpu":
        return plain(xb, w8, w_scale)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, w8, w_scale, form)


def _apply(x, w8, w_scale, bias, form):
    lead = x.shape[:-1]
    y = _matmul(x.reshape(-1, x.shape[-1]).contiguous(), w8, w_scale, form)
    if bias is not None:
        y = y + bias[None, :].to(y.dtype)
    return y.reshape(*lead, -1)


def int8_matmul(x, w8, w_scale, bias=None):
    """y = (x @ w8[:, :IN].T) * w_scale + bias.

    x: [..., IN]; w8: [OUT, IN_pad] int8; w_scale: [OUT] f32; bias: [OUT]
    or None, added after the cast to x's dtype, as ``aqlm_tpu`` adds it."""
    return _apply(x, w8, w_scale, bias, "unindexed")


def int8_matmul_indexed(x, w8_all, scale_all, layer_idx: int, bias_all=None):
    """y = (x @ w8_all[layer_idx].T) * scale_all[layer_idx] (+ bias_all[layer_idx]).

    w8_all: [L, OUT, IN_pad] int8; scale_all: [L, OUT] f32. The layer is a
    view of the stacked arrays: nothing is copied."""
    li = int(layer_idx)
    return _apply(x, w8_all[li], scale_all[li], None if bias_all is None else bias_all[li],
                  "indexed")


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


# ---------------------------------------------------------------------------
# the activation backward: dx = bf16(g * w_scale) @ w8
# ---------------------------------------------------------------------------


def scaled_grad(gb, w_scale):
    """g [rows, OUT] times the scales in f32, rounded to bf16, as
    ``aqlm_tpu``'s ``int8_matmul_transposed`` rounds it before its kernel."""
    return (gb.float() * w_scale.float()[None, :]).to(torch.bfloat16)


def plain_t(gb, w8, w_scale):
    """The backward kernel's plain version (same arguments as ``launch_t``):
    the f32 product of bf16(g * scale) and the widened weights, in bf16.
    Returns [rows, IN_pad]."""
    return torch.matmul(scaled_grad(gb, w_scale).float(), w8.float()).to(torch.bfloat16)


# B10's shapes (csrc/int8_matmul.cu): the GEMV's eight warps and its block
# widths; the GEMM's 128-column tile, 64-row slabs, ring depths and layout
T_SMEM_LIMIT = 232448
_TV_WARPS, _TV_UNROLL, _TV_MAX_ROWS = 8, 4, 512
_TG_BN, _TG_BK, _TG_STAGES = 128, 64, (4, 3, 2)
# the planner's time model of one GEMM block-slab (us, at BM 256 / 128) and of
# the split path's partial sums (written and read once, at the card's memory rate)
_TG_SLAB_US = {256: 0.55, 128: 0.35}
_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class PlanT:
    """One launch of B10: the path (``gemv`` at <= 8 rows, else ``gemm``),
    its tile (the GEMV's dx columns a block, the GEMM's rows a block), the
    GEMM's ring stages (0 for the GEMV), OUT split over ``splits`` blocks of
    ``per_split`` (GEMV: OUT rows, a multiple of 32; GEMM: 64-row slabs), the
    grid and the dynamic shared memory, which the kernel checks against its
    own layout."""

    path: str
    tile: int
    stages: int
    splits: int
    per_split: int
    grid: tuple
    smem: int

    @property
    def bm(self) -> int:
        """The launch's ``bm`` argument: 0 for the GEMV."""
        return self.tile if self.path == "gemm" else 0


def gemv_t_smem(T: int, rows: int) -> int:
    """The GEMV's dynamic shared memory: bf16(g * scale) of a split's rows as
    f32 (T rounded up to 1, 2, 4 or 8), and the eight warps' sums."""
    vw = 16 if T <= 4 else 8
    tp = 1 if T == 1 else 2 if T == 2 else 4 if T <= 4 else 8
    return rows * tp * 4 + _TV_WARPS * T * 32 * vw * 4


def gemm_t_smem(bm: int, stages: int) -> int:
    """The GEMMs' dynamic shared memory (the kernel's ``TLayout``, which the
    forward GEMM shares): each stage's bf16 A tile (bf16(g * scale), or x)
    and int8 slab, two widened W^T buffers, the barriers, the split path's
    flag, and 1024 bytes to align the swizzled A tiles."""
    ring = stages * (bm * _TG_BK * 2 + _TG_BK * _TG_BN)
    return ring + 2 * _TG_BN * _TG_BK * 2 + (3 * stages + 4) * 8 + 16 + 1024


def plan_t(T: int, out_features: int, ld: int, sm_count: int = 132) -> PlanT:
    """Path, tile, stages, split of OUT and grid of one B10 launch, a pure
    function of the shapes. At <= 8 rows the column GEMV: 512 dx columns a
    block (256 past 4 rows), OUT split over enough blocks to fill the card
    twice. Past 8 rows the GEMM (after the bf16(g * scale) pass): 256 rows a
    block past 256 rows, else 128; the deepest ring that fits; OUT split
    only where the time model (waves of one block per SM x slabs a block,
    plus the partial sums' bytes) says it pays."""
    if T < 1 or out_features < 8 or out_features % 8 or ld < 16 or ld % 16:
        raise ValueError(f"int8_matmul_transposed kernel: no plan for T={T} OUT={out_features} "
                         f"ld={ld} (OUT a multiple of 8, ld of 16)")
    if T <= INT8_GEMV_MAX_ROWS:
        cw = 32 * (16 if T <= 4 else 8)
        col_blocks = -(-ld // cw)
        splits = max(1, -(-2 * sm_count // col_blocks), -(-out_features // _TV_MAX_ROWS))
        run = _TV_WARPS * _TV_UNROLL  # rows a block's warps take at once
        rows = min(_TV_MAX_ROWS, -(-out_features // splits // run) * run)
        splits = -(-out_features // rows)  # no empty split
        return PlanT("gemv", cw, 0, splits, rows, (col_blocks, splits, 1), gemv_t_smem(T, rows))
    bm = 256 if T > 256 else 128
    stages = next(st for st in _TG_STAGES if gemm_t_smem(bm, st) <= T_SMEM_LIMIT)
    col_tiles, row_tiles = -(-ld // _TG_BN), -(-T // bm)
    n_slabs = -(-out_features // _TG_BK)
    tiles = col_tiles * row_tiles

    def cost(s):
        waves = -(-tiles * s // sm_count)
        part = 0 if s == 1 else 8 * s * row_tiles * bm * ld / _BYTES_PER_US
        return waves * -(-n_slabs // s) * _TG_SLAB_US[bm] + part

    splits = 1
    if tiles < sm_count:
        splits = min(range(1, max(1, min(16, n_slabs // 4)) + 1), key=cost)
    per_split = -(-n_slabs // splits)
    splits = -(-n_slabs // per_split)  # no empty split
    return PlanT("gemm", bm, stages, splits, per_split, (col_tiles, row_tiles, splits),
                 gemm_t_smem(bm, stages))


def launch_t(gb, w8, w_scale):
    """The backward kernel: gb [rows, OUT] bf16 or f32; w8 [OUT, IN_pad] int8;
    w_scale [OUT] f32, laid out by ``plan_t``. The scale and the bf16 rounding
    are applied as the gradient is staged (the GEMV) or by the GEMM's first
    kernel. Returns [rows, IN_pad] bf16."""
    rows, out_features = gb.shape
    dev = gb.device
    if gb.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul_transposed kernel takes bf16 or f32 gradients, got {gb.dtype}")
    if w8.dim() != 2 or w8.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul_transposed kernel takes int8 w8 [OUT, IN_pad] and f32 "
                         f"scales, got {w8.dtype} {tuple(w8.shape)} and {w_scale.dtype}")
    if w8.shape[0] != out_features or w_scale.shape != (out_features,):
        raise ValueError(f"int8_matmul_transposed kernel: g {tuple(gb.shape)} against w8 "
                         f"{tuple(w8.shape)} and w_scale {tuple(w_scale.shape)}")
    in_pad = w8.shape[1]
    if out_features % 8 or in_pad % 16:
        raise ValueError(f"int8_matmul_transposed kernel: OUT {out_features} (a multiple of 8) "
                         f"and IN_pad {in_pad} (of 16)")
    for t in (gb, w8, w_scale):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("int8_matmul_transposed kernel operands must be contiguous on one "
                             "CUDA device")
    if gb.data_ptr() % 16 or w8.data_ptr() % 16 or w_scale.data_ptr() % 16:
        raise ValueError("int8_matmul_transposed kernel needs 16-byte aligned operands")
    out = torch.empty((rows, in_pad), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return out
    p = plan_t(rows, out_features, in_pad, _build.sm_count(dev.index))
    # the GEMM's A operand, bf16(g * scale), written once by its first kernel
    gs = torch.empty_like(gb, dtype=torch.bfloat16) if p.path == "gemm" else None
    partials = tickets = None
    if p.splits > 1:
        # the splits' f32 partial sums meet here; the last block of each
        # output tile to finish adds them in a fixed order and zeroes its
        # ticket again
        t_pad = rows if p.path == "gemv" else p.grid[1] * p.tile
        partials = torch.empty((p.splits, t_pad, in_pad), dtype=torch.float32, device=dev)
        tickets = _build.tickets(dev, p.grid[0] if p.path == "gemv" else p.grid[0] * p.grid[1])
    lib, _ = _build.library()
    rc = lib.int8_matmul_t_launch(
        gb.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), None if gs is None else gs.data_ptr(),
        int(gb.dtype == torch.float32), rows, out_features, in_pad,
        p.bm, p.splits, p.per_split, p.stages, p.smem, _build.stream_ptr(dev))
    _build.check(rc, "int8_matmul_transposed")
    _build.count("int8_matmul_transposed")
    return out


def int8_matmul_transposed(g, w8, w_scale):
    """dx = bf16(g * w_scale) @ w8, the backward of ``int8_matmul`` in x.

    g: [..., OUT] bf16 or f32; w8: [OUT, IN_pad] int8; w_scale: [OUT] f32.
    Returns [..., IN_pad] bf16 (the caller slices to its in_features), as
    ``aqlm_tpu.ops.int8_matmul.int8_matmul_transposed``."""
    lead = g.shape[:-1]
    gb = g.reshape(-1, g.shape[-1]).contiguous()
    if gb.device.type == "cpu":
        dx = plain_t(gb, w8, w_scale)
    elif gb.device.type == "cuda":
        dx = launch_t(gb, w8, w_scale)
    else:
        raise ValueError(f"unsupported device {gb.device}")
    return dx.reshape(*lead, -1)
