"""Kx8 codebook dequant-matmul over the untiled codes layout, for any out_features.

PyTorch counterpart of ``aqlm_tpu.ops.kernels.fused_onehot_matmul``, the
path of every codes-mode projection whose out_features is not a multiple of
128 (Falcon-7B's q/k/v/o/fc2). On a CUDA tensor every entry point launches
kernel B15 (``csrc/onehot_matmul.cu``), laid out by the pure ``onehot_plan``:
a GEMV form for at most 8 rows (a TMA ring of code slabs, mma.sync
products) and, above, a GEMM form in K2's warp-specialised shape; on a CPU
tensor it runs the plain version.

Numerics follow the TPU kernel: each weight element is
``bf16(sum_k f32(cb_k[code_k]))``; the product accumulates in f32 and is
rounded to the activations' dtype, which is then multiplied by the scales
and added to the bias, both cast to that dtype. The bf16 rounding of the
product before the scale is where this path differs from K1/K2.

Codes layout: ``codes_t [K, IG, OUT]`` uint8 (stacked: ``[L, K, IG, OUT]``).

The module also holds the differentiable dequant's two kernels (the
calibration path and every reference-mode matmul on the card):

- B13 ``dequantize_onehot`` / ``dequantize_groups``: the dense f32 weight
  from Kx8 codes, ``csrc/calib_dequant.cu``;
- B14 ``cb_grad_segment``: the codebook gradient, a segment sum of the
  weight gradient's groups by code, S <= ``CB_GRAD_MAX_SEGMENTS``, in the
  same source, laid out by the pure ``cb_grad_plan`` (one block an SM, a
  float2 a thread added into bank-interleaved shared copies, the partial
  sums merged in block order by a second short kernel).

and B16 ``gather_wraps``, the lane-gather wrap probe (``csrc/gather_wraps.cu``),
which no kernel of the port consults.

Each has a plain version beside it, which a CPU tensor runs.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.ops import _build

__all__ = ["ONEHOT_GEMV_MAX_ROWS", "CB_GRAD_MAX_SEGMENTS", "OnehotPlan", "onehot_plan",
           "CbGradPlan", "cb_grad_plan",
           "fused_onehot_matmul",
           "fused_onehot_matmul_indexed", "dequantize_groups", "dequantize_onehot",
           "cb_grad_segment", "gather_wraps"]

ONEHOT_GEMV_MAX_ROWS = 8  # the GEMV form's largest row count; more rows take the GEMM form
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100 (B13's and B14's too)
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


@dataclasses.dataclass(frozen=True)
class OnehotPlan:
    """One launch of B15. ``gemv`` (<= 8 rows): blocks of 128 columns over
    ``splits`` runs of ``groups_per_split`` input groups (a multiple of the
    ring's 32-group stage), ``stages`` ring stages, x staged as rows of
    ``xg`` 16-byte groups. ``gemm``: ``bm`` rows a block, ``stages`` ring
    stages, ``groups_per_split`` / 8 slabs a block. ``grid`` (column blocks,
    row tiles, splits) and ``smem``, which the kernel checks against its own
    layout."""

    path: str
    bm: int
    stages: int
    splits: int
    groups_per_split: int
    xg: int
    grid: tuple
    smem: int

    def partials_shape(self, B: int, out_features: int):
        """The f32 split partial sums, None when unsplit."""
        if self.splits == 1:
            return None
        rows = B if self.path == "gemv" else self.grid[1] * self.bm
        return (self.splits, rows, out_features)

    @property
    def n_tickets(self) -> int:
        return self.grid[0] * self.grid[1]


_V_COLS, _V_GS, _V_MAX_STAGES = 128, 32, 4  # the GEMV's block columns, groups a stage, ring depth
_M_STAGES = (4, 3)  # the GEMM's ring depths tried, deepest first


def onehot_gemv_smem(K: int, S: int, stages: int, B: int, xg: int, f32: bool) -> int:
    """The GEMV form's dynamic shared memory (the kernel's ``VLayout``): the
    code ring, the codebooks, x (f32 x: hi and lo planes), the eight
    warps' sums, the stage barriers, the split flag, 1024 bytes of
    alignment slack."""
    return (stages * K * _V_GS * _V_COLS + K * S * 16 + (2 if f32 else 1) * B * xg * 16
            + 8 * 32 * 32 * 4 + 2 * stages * 8 + 16 + 1024)


def onehot_gemm_smem(bm: int, K: int, S: int, stages: int) -> int:
    """The GEMM form's dynamic shared memory (the kernel's ``MLayout``, K2's
    with the code slab as [K, 8 groups, 128 columns])."""
    return stages * (bm * 64 * 2 + 8 * K * 128) + 2 * 64 * 128 * 2 + K * S * 16 + (2 * stages + 4) * 8 \
        + 16 + 1024


def onehot_plan(B: int, out_features: int, ig: int, K: int, sm_count: int = 132, S: int = 256,
                x_dtype=torch.bfloat16) -> OnehotPlan:
    """B15's launch, a pure function of the shapes. At <= 8 rows the GEMV:
    the input groups split until the column blocks fill the card twice (k/v
    have one block), each split a whole number of 32-group stages, the ring
    as deep as the split (at most 4), and more splits while shared memory
    would overflow. Past 8 rows (bf16 x) the GEMM: 256 rows a block past 128
    rows, else 128, the deepest ring that fits, and the input split only
    where the output tiles leave SMs idle and K2's time model says it pays."""
    if B < 1 or out_features < 1 or ig < 1 or not 1 <= K <= 8 or not 1 <= S <= 256:
        raise ValueError(f"onehot_matmul kernel: no plan for B={B} OUT={out_features} IG={ig} "
                         f"K={K} S={S}")
    col_blocks = -(-out_features // _V_COLS)
    if B <= ONEHOT_GEMV_MAX_ROWS:
        if x_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"onehot_matmul GEMV takes bf16/f32 activations, got {x_dtype}")
        n_units = -(-ig // _V_GS)
        per = -(-n_units // max(1, min(n_units, -(-2 * sm_count // col_blocks))))
        while True:  # fewer groups a split while shared memory would overflow
            stages = min(_V_MAX_STAGES, per)
            xg = per * _V_GS + 4
            smem = onehot_gemv_smem(K, S, stages, B, xg, x_dtype == torch.float32)
            if smem <= SMEM_LIMIT or per == 1:
                break
            per -= 1
        splits = -(-n_units // per)  # no empty split
        if smem > SMEM_LIMIT:
            raise ValueError(f"onehot_matmul GEMV: K={K} S={S} needs {smem} bytes of shared memory")
        return OnehotPlan("gemv", 0, stages, splits, per * _V_GS, xg, (col_blocks, 1, splits), smem)
    if x_dtype != torch.bfloat16:
        raise ValueError(f"onehot_matmul GEMM takes bf16 activations, got {x_dtype}")
    bm = 128 if B <= 128 else 256
    stages = next((st for st in _M_STAGES if onehot_gemm_smem(bm, K, S, st) <= SMEM_LIMIT), None)
    if stages is None:
        raise ValueError(f"onehot_matmul GEMM: K={K} S={S} needs "
                         f"{onehot_gemm_smem(bm, K, S, _M_STAGES[-1])} bytes of shared memory")
    row_tiles, n_slabs = -(-B // bm), -(-ig // 8)
    tiles = col_blocks * row_tiles
    slab_us = {256: 0.55, 128: 0.35}[bm]  # K2's time model (gather_prefill.plan)

    def cost(s):
        waves = -(-tiles * s // sm_count)
        part = 0 if s == 1 else 8 * s * row_tiles * bm * out_features / 3.35e6
        return waves * -(-n_slabs // s) * slab_us + part

    splits = 1
    if tiles < sm_count:
        splits = min(range(1, max(1, min(16, n_slabs // 4)) + 1), key=cost)
    per = -(-n_slabs // splits)
    splits = -(-n_slabs // per)  # no empty split
    return OnehotPlan("gemm", bm, stages, splits, per * 8, 0, (col_blocks, row_tiles, splits),
                      onehot_gemm_smem(bm, K, S, stages))


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
    p = onehot_plan(B, out_features, ig, K, _build.sm_count(dev.index), S, xb.dtype)
    partials = tickets = None
    if p.splits > 1:
        partials = torch.empty(p.partials_shape(B, out_features), dtype=torch.float32, device=dev)
        tickets = torch.zeros(p.n_tickets, dtype=torch.int32, device=dev)
    lib, _ = _build.library()
    rc = lib.onehot_matmul_launch(
        xb.data_ptr(), codes_t.data_ptr(), codebooks.data_ptr(), scales.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        int(xb.dtype == torch.bfloat16), B, p.bm, p.stages, p.smem, p.splits, p.groups_per_split,
        p.xg, ig, out_features, K, S, _build.stream_ptr(dev),
    )
    _build.check(rc, "onehot_matmul")
    _build.count("onehot_matmul")
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


# ---------------------------------------------------------------------------
# B13: the dense weight from Kx8 codes (the differentiable dequant's forward)
# ---------------------------------------------------------------------------


def dequant_plain(codes, codebooks, scales=None, *, precise: bool = True):
    """B13's plain version: W [OUT, IN] f32 from canonical ``codes [OG, IG, K]``
    (read unsigned) and ``codebooks [K, S, g]``; the codebook vectors summed
    in f32 in codebook order from zero (each rounded to bf16 first unless
    ``precise``), then times ``scales [OG]`` if given."""
    og, ig, K = codes.shape
    g = codebooks.shape[-1]
    cbf = codebooks.float()
    if not precise:
        cbf = cbf.to(torch.bfloat16).float()
    idx = codes.long()
    w = torch.zeros((og, ig, g), dtype=torch.float32, device=codes.device)
    for k in range(K):
        w = w + cbf[k][idx[:, :, k]]
    w = w.reshape(og, ig * g)
    if scales is not None:
        w = w * scales.float()[:, None]
    return w


def dequant_launch(codes, codebooks, scales=None, *, precise: bool = True):
    """B13 on the card (same arguments as ``dequant_plain``): uint8 codes,
    f32 codebooks with K * S * g * 4 bytes within a block's shared memory."""
    og, ig, K = codes.shape
    Kc, S, g = codebooks.shape
    dev = codes.device
    if codes.dtype != torch.uint8 or codebooks.dtype != torch.float32:
        raise ValueError(f"dequantize kernel takes uint8 codes and f32 codebooks, got "
                         f"{codes.dtype} and {codebooks.dtype}")
    if Kc != K or S > 256 or K * S * g * 4 > SMEM_LIMIT:
        raise ValueError(f"dequantize kernel: bad shapes codes {tuple(codes.shape)} codebooks "
                         f"{tuple(codebooks.shape)}")
    if scales is not None and (scales.dtype != torch.float32 or scales.shape != (og,)):
        raise ValueError(f"dequantize kernel takes f32 scales [{og}], got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    for t in (codes, codebooks) + (() if scales is None else (scales,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("dequantize kernel operands must be contiguous on one CUDA device")
    out = torch.empty((og, ig * g), dtype=torch.float32, device=dev)
    lib, _ = _build.library()
    rc = lib.calib_dequant_launch(
        codes.data_ptr(), codebooks.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), og * ig, ig, K, S, g, int(precise), _build.stream_ptr(dev),
    )
    _build.check(rc, "dequantize_onehot")
    _build.count("dequantize_onehot")
    return out


def dequantize_groups(codes, codebooks, scales=None, *, precise: bool = True):
    """W [OUT, IN] f32 from canonical Kx8 codes: the plain version on a CPU
    tensor, B13 on a CUDA one."""
    if codes.device.type == "cpu":
        return dequant_plain(codes, codebooks, scales, precise=precise)
    if codes.device.type == "cuda":
        return dequant_launch(codes.contiguous(), codebooks.float().contiguous(),
                              None if scales is None else scales.float().contiguous(),
                              precise=precise)
    raise ValueError(f"unsupported device {codes.device}")


def dequantize_onehot(codes_t, codebooks, scales, *, group: int, dtype=torch.bfloat16,
                      precise: bool = False):
    """W^T [IN, OUT] from ``codes_t [K, IG, OUT]``, ``codebooks [K, S, g]`` and
    ``scales [OUT]``, as ``aqlm_tpu.ops.kernels.dequantize_onehot``: the f32
    sum, times the scales, in ``dtype``. A transposed view of B13's
    row-major W on the card."""
    if codebooks.shape[-1] != group:
        raise ValueError(f"codebooks of group {codebooks.shape[-1]}, expected {group}")
    codes = codes_t.permute(2, 1, 0)  # [OUT, IG, K]
    w = dequantize_groups(codes.contiguous(), codebooks, scales, precise=precise)
    return w.to(dtype).t()


# ---------------------------------------------------------------------------
# B14: the codebook-gradient segment sum (the differentiable dequant's backward)
# ---------------------------------------------------------------------------

CB_GRAD_MAX_SEGMENTS = 512


def cb_grad_plain(codes, data, num_segments: int, *, precise: bool = True):
    """B14's plain version: out[k, s] = sum of data[i] over i with
    codes[i, k] == s. codes [G, K] uint8, data [G, g];
    returns [K, num_segments, g] f32 (data rounded to bf16 first unless
    ``precise``)."""
    G, K = codes.shape
    d = data.float()
    if not precise:
        d = d.to(torch.bfloat16).float()
    idx = codes.long()
    out = torch.zeros((K, num_segments, d.shape[1]), dtype=torch.float32, device=data.device)
    for k in range(K):
        out[k].index_add_(0, idx[:, k], d)
    return out


@dataclasses.dataclass(frozen=True)
class CbGradPlan:
    """One launch of B14: ``blocks`` blocks of ``CB_GRAD_THREADS`` threads
    (one an SM at most), block b taking the groups [b * groups_per_block,
    (b + 1) * groups_per_block); a thread owns ``vec`` neighbouring columns
    (2: one float2 load), thread rows of ``cols`` lanes, ``rows`` groups a
    block step; the adds go into ``slots`` shared [K, S, g] copies (a
    warp's i-th group row into copy i: 32 / cols bank-interleaved copies
    where cols divides 32 and they fit), ``smem`` bytes. Each block writes
    the sum of its copies to a slice of the f32 partials (``partials``
    elements) and a merge kernel adds the slices in block order. The kernel
    works out the same geometry from ``blocks``, ``slots`` and ``vec``."""

    blocks: int
    vec: int
    groups_per_block: int
    cols: int
    rows: int
    slots: int
    smem: int
    partials: int


CB_GRAD_THREADS = 1024  # the kernel's block (CG_THREADS)
_CB_GRAD_MAX_BLOCKS = 256  # the merge kernel's limit (16 chunks of 16 slices)


def cb_grad_plan(G: int, K: int, S: int, g: int, sms: int, pairs: bool = True) -> CbGradPlan:
    """B14's launch geometry for ``G`` groups of ``g`` floats, K codebooks of
    S segments, on a card of ``sms`` SMs: one block an SM, and only as many
    blocks as runs of ceil(G / blocks) groups fill; a float2 a thread where
    g is even and ``pairs`` (the data 8-byte aligned)."""
    blocks = max(1, min(sms, _CB_GRAD_MAX_BLOCKS, G))
    if G:  # no empty block
        blocks = -(-G // -(-G // blocks))
    vec = 2 if pairs and g % 2 == 0 else 1
    cols = min(g // vec, CB_GRAD_THREADS)
    slots = 32 // cols if 32 % cols == 0 and K * S * 32 * vec * 4 <= SMEM_LIMIT else 1
    n_acc = K * S * g
    return CbGradPlan(blocks, vec, -(-G // blocks), cols, CB_GRAD_THREADS // cols, slots,
                      n_acc * slots * 4, blocks * n_acc)


def cb_grad_launch(codes, data, num_segments: int, *, precise: bool = True):
    """B14 on the card (same arguments as ``cb_grad_plain``): uint8 codes, f32
    data, K * S * g * 4 bytes within a block's shared memory. Allocates its
    output; the partial sums live in the stream's ``_build.scratch``."""
    G, K = codes.shape
    g = data.shape[1]
    dev = codes.device
    if codes.dtype != torch.uint8 or data.dtype != torch.float32:
        raise ValueError(f"cb_grad kernel takes uint8 codes and f32 data, got "
                         f"{codes.dtype} and {data.dtype}")
    if num_segments > CB_GRAD_MAX_SEGMENTS or data.shape[0] != G or K * num_segments * g * 4 > SMEM_LIMIT:
        raise ValueError(f"cb_grad kernel: bad shapes codes {tuple(codes.shape)} data "
                         f"{tuple(data.shape)} segments {num_segments}")
    for t in (codes, data):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("cb_grad kernel operands must be contiguous on one CUDA device")
    out = torch.empty((K, num_segments, g), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    p = cb_grad_plan(G, K, num_segments, g, _build.sm_count(dev.index), data.data_ptr() % 8 == 0)
    partials = _build.scratch(dev, p.partials)
    lib, _ = _build.library()
    rc = lib.cb_grad_launch(codes.data_ptr(), data.data_ptr(), out.data_ptr(), partials.data_ptr(),
                            G, K, num_segments, g, p.blocks, p.slots, p.vec, int(precise),
                            _build.stream_ptr(dev))
    _build.check(rc, "cb_grad_segment")
    _build.count("cb_grad_segment")
    return out


def cb_grad_segment(codes, data, num_segments: int, *, precise: bool = True):
    """Batched codebook-gradient segment sum: out[k, s] = sum of data[i] over
    i with codes[i, k] == s, for all K codebooks at once; codes [G, K] uint8
    (the Kx8 codes of the differentiable dequant, its one caller), data
    [G, g], S <= ``CB_GRAD_MAX_SEGMENTS``; returns [K, S, g] f32. The plain
    version on a CPU tensor, B14 on a CUDA one."""
    if codes.dtype != torch.uint8:
        raise ValueError(f"cb_grad_segment takes uint8 codes, got {codes.dtype}")
    if num_segments > CB_GRAD_MAX_SEGMENTS:
        raise ValueError(f"cb_grad_segment takes at most {CB_GRAD_MAX_SEGMENTS} segments, "
                         f"got {num_segments}")
    if codes.device.type == "cpu":
        return cb_grad_plain(codes, data, num_segments, precise=precise)
    if codes.device.type == "cuda":
        return cb_grad_launch(codes.contiguous(), data.float().contiguous(), num_segments,
                              precise=precise)
    raise ValueError(f"unsupported device {codes.device}")


# ---------------------------------------------------------------------------
# B16: does a gather across the 128 lanes take an index past 127 modulo 128?
# ---------------------------------------------------------------------------

_GATHER_WRAPS: dict = {}  # device type -> the probe's answer


def wrap_probe_inputs(device):
    """The probe's (8, 128) f32 table (each row 0..127) and indices 128..255."""
    lanes = torch.arange(128, device=device)
    tab = lanes.to(torch.float32).expand(8, 128).contiguous()
    idx = (lanes + 128).to(torch.int32).expand(8, 128).contiguous()
    return tab, idx


def gather_wraps_plain(tab, idx):
    """B16's plain version: the gather at ``idx % 128`` (a wrapping gather)."""
    return torch.take_along_dim(tab, (idx % 128).long(), dim=1)


def gather_wraps_launch(tab, idx):
    """B16 on the card: ``tab`` [rows, 128] f32 gathered along its lanes at
    ``idx`` [rows, 128] int32 by warp shuffles; rows <= 32."""
    rows = tab.shape[0]
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("gather_wraps kernel takes an f32 table and int32 indices")
    if tab.shape != (rows, 128) or idx.shape != tab.shape or not 1 <= rows <= 32:
        raise ValueError(f"gather_wraps kernel takes [rows <= 32, 128], got {tuple(tab.shape)} "
                         f"and {tuple(idx.shape)}")
    for t in (tab, idx):
        if t.device != tab.device or not t.is_contiguous():
            raise ValueError("gather_wraps kernel operands must be contiguous on one CUDA device")
    out = torch.empty_like(tab)
    lib, _ = _build.library()
    rc = lib.gather_wraps_launch(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                                 _build.stream_ptr(tab.device))
    _build.check(rc, "gather_wraps")
    _build.count("gather_wraps")
    return out


def gather_wraps(device=None) -> bool:
    """Whether a gather across lanes takes an out-of-range lane index modulo
    128, as ``aqlm_tpu.ops.kernels.gather_wraps`` asks of the TPU: the probe's
    gather of the (8, 128) table at indices 128..255 equals the table. On
    the card B16 runs it by warp shuffles; on the CPU the answer is False,
    as JAX's interpret mode (which clamps) gives. ``AQLM_GATHER_WRAP=0/1``
    overrides the probe. One answer per device type, kept for the process.
    No kernel of the port consults it."""
    import os

    dev = resolve_device(device)
    if dev.type not in _GATHER_WRAPS:
        env = os.environ.get("AQLM_GATHER_WRAP")
        if env is not None:
            _GATHER_WRAPS[dev.type] = env not in ("0", "false", "")
        elif dev.type == "cpu":
            _GATHER_WRAPS[dev.type] = False
        else:
            tab, idx = wrap_probe_inputs(dev)
            _GATHER_WRAPS[dev.type] = bool(torch.equal(gather_wraps_launch(tab, idx), tab))
    return _GATHER_WRAPS[dev.type]
