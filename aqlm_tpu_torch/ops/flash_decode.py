"""Single-token flash-decode attention over the head-major KV cache.

PyTorch counterparts of ``aqlm_tpu.ops.flash_decode``:

- ``flash_decode_write_attention_indexed`` (K3): writes the new row into the
  cache IN PLACE and attends over it, returning the cache tensors it was
  given, so callers read the same objects back;
- ``flash_decode_attention_indexed`` and ``flash_decode_attention`` (B6):
  attend over the cache as it is, keys below each row's length; the
  unindexed form is the indexed one at layer 0.

On a CUDA tensor each launches its kernel (``csrc/flash_decode.cu``); on a
CPU tensor it runs the plain version. The kernels split each row's keys
over blocks and merge the splits' partial softmax states in a fixed order:
at 1, 2, 4 or 8 query heads per kv head the row kernel, laid out by the pure
``row_plan`` (a row's last split merges them, in the same launch); at any
other count split-KV on the tensor cores (``split_plan``) and a combine
kernel. The plain versions compute the same way (``split_partials``,
``merge_partials``; ``kps`` sets their keys a split).

Layouts: q [B, 1, Hq, D]; k/v cache [L, B, Hkv, S, D] int8 or bf16; scales
[L, B, Hkv, S, 1] f32 (int8 only); offsets [B] int32 (K3: row b is written
at offsets[b] and attends to keys < offsets[b] + 1); lengths [B] int32 (B6).
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.ops import _build

__all__ = [
    "flash_decode_write_attention_indexed", "flash_decode_attention_indexed",
    "flash_decode_attention", "NEG_INF", "ROW_REPS", "RowPlan", "row_plan", "row_smem",
    "row_splits", "split_plan", "split_partials", "merge_partials",
]

NEG_INF = -1e30
ROW_REPS = (1, 2, 4, 8)  # query heads per kv head of the row kernels
SPLIT_TILE = 64  # keys per tile of the split-KV kernels; a split holds 1-4 (or more) tiles
# the row kernels' keys a split, the shared memory that keeps three blocks an
# SM, and the grid (kv heads x rows x splits) the smallest split may reach
ROW_KPS = (64, 128, 256)
ROW_SMEM_MAX = 75 * 1024
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100
ROW_BLOCKS_PER_SM = 4
_ROW_WARPS = 8


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """One launch of the row kernel: keys a split, splits a row in the grid
    (blockIdx.z), dynamic shared memory (checked by the kernel)."""

    kps: int
    splits: int
    smem: int


def row_smem(kps: int, d: int, rep: int, quant: bool, splits: int) -> int:
    """The row kernel's shared memory (csrc ``RowLayout``): the split's K and
    V rows and scale planes (later the warps' sums, whichever is larger),
    each warp's p [rep][16 x its 16-key tiles + 4] f32, the warps' and
    heads' softmax statistics, the row's splits' (m, l) for the merge, two
    barriers a warp (its K and V copies), a flag."""
    row = d * (1 if quant else 2)
    kv = 2 * kps * row + (8 * kps if quant else 0)
    mtw = -(-(kps // 16) // _ROW_WARPS)
    return (max(kv, _ROW_WARPS * rep * d * 4) + _ROW_WARPS * rep * (16 * mtw + 4) * 4
            + (2 * 64 + 2 * 8) * 4 + splits * 8 * 2 * 4 + _ROW_WARPS * 2 * 8 + 16)


def row_splits(s_len: int, kps: int, span: int | None) -> int:
    """Splits a row of the grid holds (csrc ``row_splits``): every split of
    the cache, or, where ``span`` (the most keys a row attends: the window)
    is shorter, the ceil(span / kps) such a run takes, counted from its
    first key."""
    full = -(-s_len // kps)
    if span is None or span <= 0 or span >= s_len:
        return full
    return min(full, -(-span // kps))


def row_plan(b: int, hkv: int, rep: int, d: int, s_len: int, quant: bool,
             span: int | None = None, sm_count: int = 132) -> RowPlan:
    """The row kernel's launch, a pure function of what the host knows (the
    offsets stay on the device). With a window (``span``, the most keys a
    row attends, shorter than the cache): the smallest split of ``ROW_KPS``
    that holds it and fits a block, so that no row merges, else the largest
    whose shared memory keeps three blocks an SM. Without one, of the splits
    that keep three blocks an SM, the smallest of at least 32 keys a query
    head (a split's partial state, rep x D f32, stays small beside its keys)
    whose grid stays within ``ROW_BLOCKS_PER_SM`` blocks an SM, else the
    largest."""
    if rep not in ROW_REPS or d not in (64, 128) or b < 1 or hkv < 1 or s_len < 1:
        raise ValueError(f"no row-kernel plan for B={b} Hkv={hkv} rep={rep} D={d} S={s_len}")
    smem = lambda k: row_smem(k, d, rep, quant, row_splits(s_len, k, span))
    fits = [k for k in ROW_KPS if smem(k) <= ROW_SMEM_MAX]
    if span is not None and 0 < span < s_len:
        # a window's rows are few keys: one split each (any shared memory), so none merges
        kps = next((k for k in ROW_KPS if k >= span and smem(k) <= SMEM_LIMIT), fits[-1])
    else:
        kps = next((k for k in fits if k >= 32 * rep and b * hkv * row_splits(s_len, k, span)
                    <= ROW_BLOCKS_PER_SM * sm_count), fits[-1])
    splits = row_splits(s_len, kps, span)
    return RowPlan(kps, splits, row_smem(kps, d, rep, quant, splits))


def split_plan(b: int, hkv: int, rep: int, s_len: int, splits: int | None = None,
               sm_count: int = 132) -> tuple[int, int]:
    """(keys per split, splits) of the split-KV kernels: the fewest tiles a
    split (1, 2 or 4) that keeps the grid within two blocks per SM, or, given
    ``splits``, that many parts of whole tiles."""
    if splits is None:
        hch = -(-rep // 128)
        tiles = 1
        while tiles < 4 and b * hkv * hch * -(-s_len // (SPLIT_TILE * tiles)) > 2 * sm_count:
            tiles *= 2
        kps = SPLIT_TILE * tiles
    else:
        if splits < 1:
            raise ValueError(f"splits must be at least 1, got {splits}")
        kps = SPLIT_TILE * -(-s_len // (SPLIT_TILE * splits))
    return kps, -(-s_len // kps)


def split_partials(logits, v, kps: int):
    """Per-split softmax state of ``logits`` [B, H, rep, S] over ``v``
    [B, H, S, D], S cut into splits of ``kps`` keys: (m [B, H, rep, Z], l,
    acc [B, H, rep, Z, D]), m the split's largest logit (-inf where every
    key is -inf, then l = 0), l the sum of exp(logit - m), acc its products
    with v. All f32."""
    s_len = logits.shape[-1]
    z = -(-s_len // kps)
    pad = z * kps - s_len
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad), value=-torch.inf)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    lg = logits.reshape(*logits.shape[:-1], z, kps)
    m = lg.amax(dim=-1)
    p = torch.exp(lg - torch.where(torch.isneginf(m), 0.0, m)[..., None])
    acc = torch.einsum("bhrzk,bhzkd->bhrzd", p, v.reshape(*v.shape[:2], z, kps, v.shape[-1]))
    return m, p.sum(dim=-1), acc


def merge_partials(m, l, acc):
    """The kernels' combine: the splits' states merged in split order 0, 1,
    ... (empty splits, l = 0, skipped); f32 [B, H, rep, D]."""
    mx = torch.where(l > 0, m, torch.full_like(m, NEG_INF)).amax(dim=-1)
    num = torch.zeros_like(acc[..., 0, :])
    den = torch.zeros_like(mx)
    for z in range(m.shape[-1]):
        c = torch.where(l[..., z] > 0, torch.exp(m[..., z] - mx), torch.zeros_like(mx))
        num = num + c[..., None] * acc[..., z, :]
        den = den + c * l[..., z]
    return num / torch.clamp(den, min=1e-30)[..., None]


def _row_starts(pos, s_len, window, write, ts=0, n_tiles=0):
    """Each row's first key (csrc ``key_range``), where the row kernel's
    splits start: K3 (``write``) at offsets ``pos``, B6 at lengths ``pos``
    (a row with no key in range starts at the first tile the TPU grid
    visits)."""
    pos = pos.long()
    zero = torch.zeros_like(pos)
    if write:
        return torch.clamp(pos + 1 - window, min=0) if window else zero
    start = torch.clamp(pos - window, min=0) if window else zero
    nt_full = -(-s_len // ts)
    st = torch.clamp(start // ts, max=nt_full - n_tiles) if n_tiles < nt_full else zero
    return torch.where(torch.clamp(pos, max=s_len) <= start, st * ts, start)


def _attend(logits, v, splits, kps=None, starts=None):
    """softmax(logits) @ v in f32, as ``splits`` parts from key 0 merged in
    order, or (``kps``) as the row kernel splits each row: parts of ``kps``
    keys from the row's first key, ``starts`` [B]."""
    if kps is None:
        kps, _ = split_plan(1, 1, 1, logits.shape[-1], splits or 1)
        return merge_partials(*split_partials(logits, v, kps))
    return torch.cat([merge_partials(*split_partials(logits[i:i + 1, ..., s:], v[i:i + 1, :, s:], kps))
                      for i, s in enumerate(starts.tolist())])


def plain(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window, splits=None,
          out_dtype=torch.bfloat16, kps=None):
    """K3's plain version. One layer's cache [B, Hkv, S, D] (+ scales
    [B, Hkv, S, 1]); q_hm [B, Hkv, rep, D] bf16; nk/nv [B, Hkv, D]; nks/nvs
    [B, Hkv] or None. The keys are cut into ``splits`` parts (None: one), or
    into parts of ``kps`` keys from each row's first key (the row kernel's
    splits), whose softmax states merge as the kernels merge them; the f32
    result is cast to ``out_dtype``."""
    b = q_hm.shape[0]
    s_len = k_c.shape[2]
    rows = torch.arange(b, device=k_c.device)
    off = offsets.long()
    k_c[rows, :, off] = nk
    v_c[rows, :, off] = nv
    if ks_c is not None:
        ks_c[rows, :, off] = nks[..., None]
        vs_c[rows, :, off] = nvs[..., None]
        k = k_c.float() * ks_c.float()
        v = v_c.float() * vs_c.float()
    else:
        k, v = k_c.float(), v_c.float()
    logits = torch.einsum("bhrd,bhsd->bhrs", q_hm.float(), k) * scale
    length = (off + 1)[:, None, None, None]
    key_pos = torch.arange(s_len, device=k_c.device)[None, None, None, :]
    valid = key_pos < length
    if window is not None:
        valid = valid & (key_pos >= length - window)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    starts = None if kps is None else _row_starts(off, s_len, window, True)
    return _attend(logits, v, splits, kps, starts).to(out_dtype)


def _check(q_hm, k_c, v_c, ks_c, vs_c, rows, *new) -> bool:
    """Raise unless the operands suit the flash-decode kernels: q_hm [B, Hkv,
    rep, D] bf16, a cache [B, Hkv, S, D] in int8 (with f32 scale planes) or
    bf16, ``rows`` [B] int32 (offsets or lengths), and ``new`` (K3's new rows
    and their scales), all contiguous on one device. Returns whether the
    cache is int8."""
    b, hkv, rep, d = q_hm.shape
    quant = k_c.dtype == torch.int8
    if d not in (64, 128) or rep < 1:
        raise NotImplementedError(f"flash_decode kernel takes head_dim 64/128 and at least one query "
                                  f"head per kv head, got D={d}, rep={rep}")
    if not quant and k_c.dtype != torch.bfloat16:
        raise ValueError(f"flash_decode kernel takes an int8 or bf16 cache, got {k_c.dtype}")
    if quant and (ks_c is None or vs_c is None or ks_c.dtype != torch.float32
                  or vs_c.dtype != torch.float32 or any(t is None for t in new)):
        raise ValueError("an int8 cache needs f32 scale planes (and new-row scales)")
    if rows.dtype != torch.int32 or rows.shape != (b,):
        raise ValueError("offsets and lengths must be int32 [B]")
    if (k_c.shape != (b, hkv, k_c.shape[2], d) or v_c.shape != k_c.shape
            or v_c.dtype != k_c.dtype):
        raise ValueError(f"cache {tuple(k_c.shape)} does not match q {tuple(q_hm.shape)}")
    ops = [q_hm, k_c, v_c, rows] + [t for t in new if t is not None]
    ops += [ks_c, vs_c] if quant else []
    for t in ops:
        if t.device != q_hm.device or not t.is_contiguous():
            raise ValueError("flash_decode kernel operands must be contiguous on one CUDA device")
    return quant


@dataclasses.dataclass
class _Scratch:
    """A launch's split layout and scratch: keys a split, splits a row, the
    row kernel's shared memory (0 for split-KV), the f32 partials (None for
    one split) and the row kernel's tickets."""

    kps: int
    splits: int
    smem: int
    acc: torch.Tensor | None = None
    ml: torch.Tensor | None = None
    tickets: torch.Tensor | None = None


def _scratch(q_hm, s_len, quant, span, splits) -> _Scratch:
    """The launch's ``_Scratch``, allocated on torch's current stream (no
    memset): the row kernel at 1/2/4/8 heads per kv head (``row_plan``), else
    split-KV (``split_plan``; ``splits`` overrides)."""
    b, hkv, rep, d = q_hm.shape
    dev = q_hm.device
    sms = _build.sm_count(dev.index)
    if rep in ROW_REPS:
        p = row_plan(b, hkv, rep, d, s_len, quant, span, sms)
        sc = _Scratch(p.kps, p.splits, p.smem)
        if p.splits == 1:
            return sc
        sc.tickets = _build.tickets(dev, b * hkv)
    else:
        kps, z = split_plan(b, hkv, rep, s_len, splits, sms)
        sc = _Scratch(kps, z, 0)
    n = b * hkv * sc.splits * rep
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=dev)
    sc.acc, sc.ml = part[:n * d], part[n * d:]
    return sc


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window, splits=None):
    """K3 on one layer's cache (same arguments as ``plain``; ``splits``
    overrides the split-KV kernel's split count). Each offset must lie in
    [0, S), as the caller (the Engine) guarantees; the kernel does not read
    offsets back to the host, so a row whose offset lies outside writes
    nothing and returns NaN instead of raising. Launches on two streams may
    overlap: each stream has its own tickets (``_build.tickets``)."""
    b, hkv, rep, d = q_hm.shape
    s_len = k_c.shape[2]
    dev = q_hm.device
    quant = _check(q_hm, k_c, v_c, ks_c, vs_c, offsets, nk, nv,
                   *((nks, nvs) if k_c.dtype == torch.int8 else ()))
    if rep not in ROW_REPS and (nk.data_ptr() % 16 or nv.data_ptr() % 16):
        # the split-KV kernel copies the new row as cache rows are copied
        raise ValueError("flash_decode kernel needs 16-byte aligned new rows at this head count")
    out = torch.empty((b, hkv, rep, d), dtype=torch.bfloat16, device=dev)
    sc = _scratch(q_hm, s_len, quant, window, splits)
    lib, _ = _build.library()
    rc = lib.flash_decode_write_launch(
        q_hm.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        nks.data_ptr() if quant else None, nvs.data_ptr() if quant else None,
        k_c.data_ptr(), v_c.data_ptr(),
        ks_c.data_ptr() if quant else None, vs_c.data_ptr() if quant else None,
        offsets.data_ptr(), out.data_ptr(), _ptr(sc.acc), _ptr(sc.ml), _ptr(sc.tickets),
        b, hkv, s_len, d, rep, int(quant), 0 if window is None else int(window), sc.kps,
        sc.splits, sc.smem, float(scale), _build.stream_ptr(dev),
    )
    _build.check(rc, "flash_decode_write")
    _build.count("flash_decode_write")
    return out


def flash_decode_write_attention_indexed(
    q, k_new, v_new, k_all, v_all, ks_all, vs_all, layer_idx: int, offsets,
    *, k_scale_new=None, v_scale_new=None, scale: float | None = None,
    window: int | None = None,
):
    """Writes the new KV row (and scales) of every batch row b into layer
    ``layer_idx`` at ``offsets[b]``, in place, and returns flash attention of
    the single query token over keys < offsets + 1 (within ``window`` when
    given).

    q [B, 1, Hq, D]; k_new/v_new [B, 1, Hkv, D]; k_scale_new/v_scale_new
    [B, 1, Hkv, 1] for an int8 cache. Returns (attn [B, 1, Hq, D] bf16,
    k_all, v_all, ks_all, vs_all), the caches being the objects passed in."""
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError("flash decode is the single-token path")
    hkv = k_all.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} kv heads")
    rep = hq // hkv
    if scale is None:
        scale = d ** -0.5
    li = int(layer_idx)
    q_hm = q.reshape(b, hkv, rep, d).to(torch.bfloat16).contiguous()
    nk = k_new[:, 0].to(k_all.dtype).contiguous()
    nv = v_new[:, 0].to(v_all.dtype).contiguous()
    nks = None if k_scale_new is None else k_scale_new[:, 0, :, 0].float().contiguous()
    nvs = None if v_scale_new is None else v_scale_new[:, 0, :, 0].float().contiguous()
    k_c, v_c = k_all[li], v_all[li]
    ks_c = None if ks_all is None else ks_all[li]
    vs_c = None if vs_all is None else vs_all[li]
    if q.device.type == "cpu":
        attn = plain(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window)
    elif q.device.type == "cuda":
        attn = launch(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return attn.reshape(b, 1, hq, d), k_all, v_all, ks_all, vs_all


# ---------------------------------------------------------------------------
# B6: flash decode over the cache as it is (no row write)
# ---------------------------------------------------------------------------


def tiles(s_len: int, window: int | None) -> tuple[int, int, int]:
    """The TPU grid's tile length, tile count and visited tile count: with a
    window shorter than the cache only ceil(window / ts) + 1 tiles are
    visited (``aqlm_tpu/ops/flash_decode.py:102-111``)."""
    ts = min(512, s_len)
    nt_full = -(-s_len // ts)
    n_tiles = nt_full
    if window is not None and window < s_len:
        n_tiles = min(nt_full, -(-window // ts) + 1)
    return ts, nt_full, n_tiles


def plain_attend(q_hm, k_c, v_c, ks_c, vs_c, lengths, scale, window, splits=None,
                 out_dtype=torch.bfloat16, kps=None):
    """B6's plain version on one layer's cache [B, Hkv, S, D] (+ scales
    [B, Hkv, S, 1]); q_hm [B, Hkv, rep, D] bf16; lengths [B]; ``splits``,
    ``out_dtype`` and ``kps`` as for ``plain``.

    Keys in [max(0, len - window), len) attend. Keys of the tiles the TPU
    grid visits that fall outside get the logit NEG_INF, as the TPU kernel
    gives them, so a row with no key in range (a length of 0) returns the
    mean of V over the visited tiles, as the TPU kernel does."""
    s_len = k_c.shape[2]
    if ks_c is not None:
        k, v = k_c.float() * ks_c.float(), v_c.float() * vs_c.float()
    else:
        k, v = k_c.float(), v_c.float()
    logits = torch.einsum("bhrd,bhsd->bhrs", q_hm.float(), k) * scale
    length = lengths.long()[:, None]
    pos = torch.arange(s_len, device=k_c.device)[None, :]
    valid = pos < length
    if window is not None:
        valid = valid & (pos >= length - window)
    ts, nt_full, n_tiles = tiles(s_len, window)
    start = torch.zeros_like(length)
    if n_tiles < nt_full:
        start = torch.clamp(torch.clamp(length - window, min=0) // ts, 0, nt_full - n_tiles)
    visited = (pos >= start * ts) & (pos < (start + n_tiles) * ts)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    logits = torch.where(visited[:, None, None, :], logits, torch.full_like(logits, -torch.inf))
    starts = None if kps is None else _row_starts(lengths, s_len, window, False, ts, n_tiles)
    return _attend(logits, v, splits, kps, starts).to(out_dtype)


def _b6_span(s_len, window):
    """The most keys a B6 row attends with a window: the window, or the
    tiles the TPU grid visits for a row with no key in range."""
    if not window:
        return None
    ts, _, n_tiles = tiles(s_len, window)
    return max(window, n_tiles * ts)


def launch_attend(q_hm, k_c, v_c, ks_c, vs_c, lengths, scale, window, splits=None):
    """B6 on one layer's cache (same arguments as ``plain_attend``;
    ``splits`` and streams as for ``launch``). The cache is only read;
    lengths are not read back to the host."""
    b, hkv, rep, d = q_hm.shape
    s_len = k_c.shape[2]
    dev = q_hm.device
    quant = _check(q_hm, k_c, v_c, ks_c, vs_c, lengths)
    ts, _, n_tiles = tiles(s_len, window)
    out = torch.empty((b, hkv, rep, d), dtype=torch.bfloat16, device=dev)
    sc = _scratch(q_hm, s_len, quant, _b6_span(s_len, window), splits)
    lib, _ = _build.library()
    rc = lib.flash_decode_launch(
        q_hm.data_ptr(), k_c.data_ptr(), v_c.data_ptr(),
        ks_c.data_ptr() if quant else None, vs_c.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(), _ptr(sc.acc), _ptr(sc.ml), _ptr(sc.tickets), b, hkv,
        s_len, d, rep, int(quant), 0 if window is None else int(window), ts, n_tiles, sc.kps,
        sc.splits, sc.smem, float(scale), _build.stream_ptr(dev),
    )
    _build.check(rc, "flash_decode")
    _build.count("flash_decode")
    return out


def flash_decode_attention_indexed(q, k_all, v_all, ks_all, vs_all, layer_idx: int, lengths, *,
                                   scale: float | None = None, window: int | None = None):
    """Flash decode of the single query token over layer ``layer_idx`` of the
    stacked cache, read in place: keys < lengths[b] (within ``window`` when
    given). q [B, 1, Hq, D]; k_all/v_all [L, B, Hkv, S, D]; ks_all/vs_all
    [L, B, Hkv, S, 1] f32 or None. Returns [B, 1, Hq, D] bf16."""
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError("flash decode is the single-token path")
    hkv = k_all.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} kv heads")
    if scale is None:
        scale = d ** -0.5
    li = int(layer_idx)
    q_hm = q.reshape(b, hkv, hq // hkv, d).to(torch.bfloat16).contiguous()
    k_c, v_c = k_all[li], v_all[li]
    ks_c = None if ks_all is None else ks_all[li]
    vs_c = None if vs_all is None else vs_all[li]
    if q.device.type == "cpu":
        out = plain_attend(q_hm, k_c, v_c, ks_c, vs_c, lengths, scale, window)
    elif q.device.type == "cuda":
        out = launch_attend(q_hm, k_c, v_c, ks_c, vs_c, lengths, scale, window)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out.reshape(b, 1, hq, d)


def flash_decode_attention(q, k_hm, v_hm, k_scale, v_scale, lengths, *,
                           scale: float | None = None, window: int | None = None):
    """``flash_decode_attention_indexed`` over one layer's cache: k_hm/v_hm
    [B, Hkv, S, D], k_scale/v_scale [B, Hkv, S, 1] f32 or None."""
    lift = lambda a: None if a is None else a[None]
    return flash_decode_attention_indexed(q, lift(k_hm), lift(v_hm), lift(k_scale), lift(v_scale),
                                          0, lengths, scale=scale, window=window)
