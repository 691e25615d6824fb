"""Kx8 gather-dequant prefill GEMM over the tiled codes layout.

PyTorch counterpart of ``aqlm_tpu.ops.gather_prefill``. On a CUDA tensor
every matmul entry point launches kernel K2 (``csrc/gather_prefill.cu``,
laid out by the pure ``plan``; ``moe_launch`` runs all experts of a
stacked projection in one launch), and
``gather_dequant_wt`` (the dense W^T of the codes-mode backward) launches
B5 (``csrc/gather_dequant_wt.cu``); on a CPU tensor each runs its plain
version. Numerics follow the TPU kernels: the codebook vectors are summed in
f32 and rounded to bf16 before the product, which accumulates in f32; scales
apply in the epilogue (for B5: times the f32 sum, then one rounding).
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops.lut_gemv import dequant_tiled_t, proj_map_for

__all__ = [
    "SMEM_LIMIT", "Plan", "plan", "smem_bytes",
    "gather_prefill_matmul",
    "gather_prefill_matmul_indexed",
    "gather_prefill_matmul_grouped_indexed",
    "gather_dequant_wt", "WtPlan", "dequant_wt_plan",
]

_KERNEL_GROUP = 8
_BN, _BK = 128, 64  # output columns of a block, input-slab width of the kernel
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
_STAGES = (4, 3)  # ring depths tried, deepest first
# the planner's time model of one block-slab (us, at BM 256 / 128) and of the
# split path's partial sums (written and read once, at the card's memory rate)
_SLAB_US = {256: 0.55, 128: 0.35}
_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class Plan:
    """One K2 launch: rows a block (``bm``), ring stages, blocks along the
    input dimension (``splits`` of ``per_split`` 64-wide slabs), the grid
    (column tiles, row tiles, experts x splits) and the dynamic shared
    memory, which the kernel checks against its own layout."""

    bm: int
    stages: int
    splits: int
    per_split: int
    grid: tuple
    smem: int

    @property
    def partials_shape(self):
        return None if self.splits == 1 else (self.grid[2], self.grid[1] * self.bm,
                                              self.grid[0] * _BN)


def smem_bytes(bm: int, K: int, S: int, stages: int) -> int:
    """K2's dynamic shared memory (the kernel's ``Layout``): the activation
    and code slabs of every stage, two W^T tiles, the codebooks, the stage
    barriers, the split path's flag, and 1024 bytes to align the
    128B-swizzled activation tiles."""
    x_and_codes = stages * (bm * _BK * 2 + (_BK // _KERNEL_GROUP) * K * _BN)
    return x_and_codes + 2 * _BK * _BN * 2 + K * S * 16 + (2 * stages + 4) * 8 + 16 + 1024


def plan(T: int, out_features: int, in_features: int, K: int, S: int, experts: int = 1,
         out_dtype=torch.bfloat16, sm_count: int = 132) -> Plan:
    """Tiles, stages, splits, grid and shared memory of one K2 launch, a pure
    function of the shapes. 256 rows a block past 128 rows (each weight is
    dequantised ceil(T / 256) times), else 128; the deepest ring that fits in
    SMEM_LIMIT; the input dimension split over blocks only where the time
    model (waves of one block per SM x slabs a block, plus the partial sums'
    bytes) says it pays, as for short prompts and narrow projections."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_prefill kernel writes bf16 or f32, got {out_dtype}")
    if T < 1 or experts < 1 or out_features % _BN or in_features % _BK or not 1 <= K <= 8 \
            or not 1 <= S <= 256:
        raise ValueError(f"gather_prefill kernel: no plan for T={T} OUT={out_features} "
                         f"IN={in_features} K={K} S={S} E={experts}")
    bm = 128 if T <= 128 else 256
    col_tiles, row_tiles, n_slabs = out_features // _BN, -(-T // bm), in_features // _BK
    stages = next((st for st in _STAGES if smem_bytes(bm, K, S, st) <= SMEM_LIMIT), None)
    if stages is None:
        raise ValueError(f"gather_prefill kernel: K={K} S={S} needs "
                         f"{smem_bytes(bm, K, S, _STAGES[-1])} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    tiles = col_tiles * row_tiles * experts

    def cost(s):
        waves = -(-tiles * s // sm_count)
        part = 0 if s == 1 else 8 * s * row_tiles * bm * out_features * experts / _BYTES_PER_US
        return waves * -(-n_slabs // s) * _SLAB_US[bm] + part

    splits = 1
    if tiles < sm_count:
        splits = min(range(1, max(1, min(16, n_slabs // 4)) + 1), key=cost)
    per_split = -(-n_slabs // splits)
    splits = -(-n_slabs // per_split)  # no empty split
    return Plan(bm, stages, splits, per_split, (col_tiles, row_tiles, experts * splits),
                smem_bytes(bm, K, S, stages))


def plain(xb, codes_tl, codebooks, scales, proj_map, out_dtype=None):
    """K2's plain version on one layer's arrays (same arguments as ``launch``)."""
    wt = dequant_tiled_t(codes_tl, codebooks, proj_map).to(torch.bfloat16).float()
    y = torch.matmul(xb.float(), wt) * scales.float()[None, :]
    return y.to(out_dtype or xb.dtype)


def _launch(x, codes_e, cb_e, scales_e, proj_map, group, out_dtype, counter, form=None):
    """K2 over E experts in one launch: x [T, IN] shared or [E, T, IN] one
    per expert, bf16; codes_e [E, NT, K*IG, tn] uint8; cb_e [E, P, K, S, 8]
    bf16; scales_e [E, OUT] f32; proj_map [NT] int32 or None. Returns
    [E, T, OUT] in ``out_dtype``."""
    E, nt, kig, tn = codes_e.shape
    _, P, K, S, g = cb_e.shape
    T, in_features = x.shape[-2:]
    dev = x.device
    if group != _KERNEL_GROUP or g != _KERNEL_GROUP:
        raise NotImplementedError(f"gather_prefill kernel takes in_group_size 8, got {group}")
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_prefill kernel takes bf16 activations and a bf16 or f32 output, "
                         f"got {x.dtype} -> {out_dtype}")
    if codes_e.dtype != torch.uint8 or cb_e.dtype != torch.bfloat16 or scales_e.dtype != torch.float32:
        raise ValueError("gather_prefill kernel takes uint8 codes, bf16 codebooks and f32 scales")
    if (K > 8 or S > 256 or kig % K or in_features != kig // K * g
            or in_features % _BK or tn % _BN or cb_e.shape[0] != E
            or (x.dim() == 3 and x.shape[0] != E) or x.dim() not in (2, 3)):
        raise ValueError(f"gather_prefill kernel: bad shapes x {tuple(x.shape)} codes "
                         f"{tuple(codes_e.shape)} codebooks {tuple(cb_e.shape)}")
    if scales_e.shape != (E, nt * tn):
        raise ValueError(f"scales {tuple(scales_e.shape)} do not match OUT={nt * tn}")
    if proj_map is not None and (proj_map.dtype != torch.int32 or proj_map.shape != (nt,)):
        raise ValueError("proj_map must be int32 [NT]")
    for t in (x, codes_e, cb_e, scales_e) + (() if proj_map is None else (proj_map,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gather_prefill kernel operands must be contiguous on one CUDA device")
    if P > 1 and proj_map is None:
        raise ValueError("grouped codebooks need a proj_map")
    if codes_e.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("gather_prefill kernel needs 16-byte aligned codes and activations")
    out = torch.empty((E, T, nt * tn), dtype=out_dtype, device=dev)
    if T == 0:
        return out
    p = plan(T, nt * tn, in_features, K, S, E, out_dtype, _build.sm_count(dev.index))
    partials = tickets = None
    if p.splits > 1:
        partials = torch.empty(p.partials_shape, dtype=torch.float32, device=dev)
        tickets = torch.zeros((E, p.grid[1], p.grid[0]), dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.gather_prefill_launch(
        x.data_ptr(), codes_e.data_ptr(), cb_e.data_ptr(), scales_e.data_ptr(),
        None if proj_map is None else proj_map.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), int(out_dtype == torch.bfloat16),
        p.bm, p.stages, p.smem, T, p.splits, p.per_split, E, nt, kig, tn, K, S, in_features,
        int(x.dim() == 3), nt * kig * tn, P * K * S * g,
        _build.stream_ptr(dev),
    )
    _build.check(rc, "gather_prefill")
    _build.count(counter, form)
    return out


def launch(xb, codes_tl, codebooks, scales, proj_map, group, out_dtype=torch.bfloat16,
           form="unindexed"):
    """K2 on one layer's arrays: xb [T, IN] bf16; codes_tl [NT, K*IG, tn]
    uint8; codebooks [P, K, S, 8] bf16; scales [OUT] f32; proj_map or None.
    Returns [T, OUT] in ``out_dtype`` (bf16 or f32); ``form`` is the
    wrapper's, for the launch count."""
    return _launch(xb, codes_tl[None], codebooks[None], scales[None], proj_map, group, out_dtype,
                   "gather_prefill", form)[0]


def moe_launch(x, codes_tl_e, codebooks_e, scales_e, group):
    """K2's f32 instance over every expert in one launch: x [N, IN] shared
    or [E, N, IN] one per expert, bf16; codes_tl_e [E, NT, K*IG, tn] uint8;
    codebooks_e [E, K, S, 8] bf16; scales_e [E, OUT] f32. Returns f32
    [E, N, OUT]; counts on ``moe_gather_prefill``."""
    return _launch(x, codes_tl_e, codebooks_e[:, None], scales_e, None, group, torch.float32,
                   "moe_gather_prefill")


def _matmul(xb, codes_tl, codebooks, scales, proj_map, group, form="unindexed"):
    """Dispatch on the device of the activations: CPU -> plain, CUDA -> K2."""
    if xb.device.type == "cpu":
        return plain(xb, codes_tl, codebooks, scales, proj_map)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    return launch(xb, codes_tl, codebooks, scales, proj_map, group, form=form)


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
    y = _matmul(xb, codes_tl_all[li], codebooks_all[li][None], scales_all[li], None, group,
                "indexed")
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
    y = _matmul(xb, codes_tl_all[li], codebooks_all[li], scales_all[li], proj_map, group,
                "indexed")
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


_WT_WARPS = 8  # warps of a B5 block (WT_THREADS / 32)
_WT_BLOCKS_PER_SM = 2
_WT_COLS = 256  # output columns of a unit: 8 a lane


@dataclasses.dataclass(frozen=True)
class WtPlan:
    """One B5 launch: a unit is one input group by ``_WT_COLS`` output
    columns, ``chunks`` of them across OUT; a lane takes ``runs`` runs of
    ``run`` consecutive columns (one 16-byte store a row each), ``run``
    x 32 columns apart; ``blocks`` of ``_WT_WARPS`` warps walk the ``units``
    warp-strided, column chunk fastest."""

    run: int
    runs: int
    chunks: int
    units: int
    blocks: int


def dequant_wt_plan(out_features: int, in_groups: int, dtype=torch.bfloat16,
                    sm_count: int = 132) -> WtPlan:
    """B5's launch geometry, a pure function of the shapes (the kernel's
    ``launch_typed`` computes the same): 8 bf16 or 4 f32 columns a run, two
    blocks an SM at most, none empty."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_dequant_wt kernel writes bf16 or f32, got {dtype}")
    run = 16 // (2 if dtype == torch.bfloat16 else 4)
    chunks = -(-out_features // _WT_COLS)
    units = chunks * in_groups
    blocks = min(-(-units // _WT_WARPS), _WT_BLOCKS_PER_SM * sm_count)
    return WtPlan(run, _KERNEL_GROUP // run, chunks, units, blocks)


def dequant_wt_launch(codes_tl, codebooks, scales, dtype=torch.bfloat16):
    """B5 on the card: codes_tl [NT, K*IG, tn] uint8 (ig-major rows, tn a
    multiple of 8); codebooks [K, S<=256, 8] bf16; scales [OUT] f32;
    ``dtype`` bf16 or f32. Returns W^T [IN, OUT] in ``dtype``."""
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
    if K < 1 or K > 8 or S > 256 or kig % K or tn % 8:
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
    _build.count("gather_dequant_wt")
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
