"""B1's launch plan (``gather16.plan``) and B15's (``kernels.onehot_plan``) at
Llama-2-7B 1x16 and Falcon-7B shapes, models of the new kernels' shared- and
device-memory access patterns, and both kernels' plain versions against
aqlm_tpu at the plans' boundaries, on the CPU.

The plans are pure functions of the shapes, so a launch that would need more
shared memory than a block may use, leave a split empty, miss an output tile
or an input group, or let two lanes of a shared-memory phase meet in a bank
fails here and not first on the card. The kernels themselves run only on the
card (tests/test_torch_cuda.py).

Bank model: a warp's 16-byte shared-memory accesses are served a quarter
warp (8 lanes) at a time, and such a phase is one wavefront when its lanes'
16-byte slots (address / 16 mod 8) are distinct or their addresses equal.

Tolerances against aqlm_tpu: bf16 outputs within one bf16 step for B1 (2^-7
|ref| + 1e-3 max|ref|: each side rounds an f32 sum taken in another order)
and two for B15 (it rounds the product, then the scaled product); f32
outputs within 1e-5 of max|ref| (B15's f32 x: the kernel's hi + lo bf16
split keeps 16 bits, about 1e-5 relative, which the plain version's f32 sum
does not model)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import gather16 as jg
from aqlm_tpu.ops import kernels as jk
from aqlm_tpu_torch.ops import gather16 as g16
from aqlm_tpu_torch.ops import kernels as k15

ROWS = [1, 4, 8, 9, 64, 200, 256, 1024]

# (name, OUT, IN, g): Llama-2-7B 1x16's q/k/v/o, gate/up and down at g 8 and
# 16, and the card tests' ragged shapes
B1_SHAPES = [("q", 4096, 4096, 8), ("gate", 11008, 4096, 8), ("down", 4096, 11008, 8),
             ("q_g16", 4096, 4096, 16), ("gate_g16", 11008, 4096, 16), ("down_g16", 4096, 11008, 16),
             ("card_520", 520, 1024, 8), ("card_200_g16", 200, 2048, 16)]

# (name, OUT, IN): Falcon-7B's q/o, k/v and fc2, and the JAX tests' widths
B15_SHAPES = [("q", 4544, 4544), ("kv", 64, 4544), ("fc2", 4544, 18176), ("out96", 96, 4544),
              ("out200", 200, 4544), ("jax_200", 200, 200), ("ragged_37", 37, 128)]


def _b1_dtypes(rows):
    return (torch.bfloat16, torch.float32) if rows <= 8 else (torch.bfloat16,)


def _gemv_rows_and_codes(p, out_f, ig, g, first):
    """The GEMV's walk: in the first design warp w of block b takes row b*16
    + w and lane l codes c*256 + 8l .. +8 of chunk c; in the g=16 lane-pair
    kernel warp w takes the row pairs b*8 + w + k*8*blocks (rows 2q, 2q+1)
    and lane pair l codes c*128 + 8l .. +8."""
    if first:
        warps = p.grid[0] * 16
        rows = [r for w in range(warps) for r in range(w, out_f, warps)]
        lpc = 1
    else:
        warps = p.grid[0] * 8
        rows = [2 * q + r for w in range(warps) for q in range(w, -(-out_f // 2), warps)
                for r in range(2) if 2 * q + r < out_f]
        lpc = 2
    ch = 8 * 32 // lpc
    codes = [c * ch + 8 * lg + j for c in range(-(-ig // ch)) for lg in range(32 // lpc)
             for j in range(8) if c * ch + 8 * lg < ig]
    return rows, codes


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", B1_SHAPES, ids=lambda s: s[0])
def test_gather16_plan_fits_and_covers(shape, rows):
    _, out_f, in_f, g = shape
    ig = in_f // g
    for dt in _b1_dtypes(rows):
        p = g16.plan(rows, out_f, ig, g, 132, dt)
        assert p.smem <= g16.SMEM_LIMIT
        first = g == 8 or rows > 4  # the first design: 16 rows a block, x a chunk at a time
        if rows <= 8 and first:
            x_bytes = 2 if dt == torch.bfloat16 else 4
            assert p.path == "gemv" and p.x_staged and p.grid == (-(-out_f // 16),)
            assert p.smem == rows * 32 * (8 * (g * x_bytes // 16) + 1) * 16
        if rows <= 8:
            if not first:
                full = g16.gemv_smem(rows, ig, g, 2 if dt == torch.bfloat16 else 4)
                assert p.path == "gemv" and p.x_staged == (full <= g16.SMEM_LIMIT)
                assert p.smem == (full if p.x_staged else 0)
                assert 1 <= p.grid[0] <= min(-(-out_f // 16), 2 * 132)
                if p.x_staged:
                    assert p.grid[0] <= 132 * max(1, 233472 // (p.smem + 1024))
            got_rows, got_codes = _gemv_rows_and_codes(p, out_f, ig, g, first)
            assert sorted(got_rows) == list(range(out_f))  # every row once
            assert sorted(got_codes) == list(range(ig))  # every code of a row once
            continue
        assert p.path == "gemm" and p.bm == (128 if rows <= 128 else 256)
        assert p.smem == g16.gemm_smem(p.bm, p.stages)
        col_tiles, row_tiles, n_slabs = -(-out_f // 128), -(-rows // p.bm), in_f // 64
        assert p.grid == (col_tiles, row_tiles, p.splits)
        assert (p.splits - 1) * p.per_split < n_slabs <= p.splits * p.per_split  # none empty
        if p.splits > 1:
            assert col_tiles * row_tiles < 132  # split only where tiles leave SMs idle
        # every slab of every tile once, over the splits
        slabs = [s for z in range(p.splits) for s in range(z * p.per_split,
                                                           min(n_slabs, (z + 1) * p.per_split))]
        assert slabs == list(range(n_slabs))
        assert p.gathers_per_weight == 1 <= 2  # the pre-pass gathers each weight once
        assert p.scratch_bytes == out_f * in_f * 2
        assert p.prepass_blocks >= 1
        assert p.partials_shape(rows, out_f) == (None if p.splits == 1 else
                                                (p.splits, row_tiles * p.bm, out_f))


def test_gather16_plan_refuses():
    with pytest.raises(ValueError):
        g16.plan(4, 4096, 4096 // 4, 4)  # g 4
    with pytest.raises(ValueError):
        g16.plan(4, 4096, 12, 8)  # IG not a multiple of 8
    with pytest.raises(ValueError):
        g16.plan(0, 4096, 512, 8)
    with pytest.raises(ValueError):
        g16.plan(9, 4096, 512, 8, 132, torch.float32)  # the GEMM takes bf16 x
    with pytest.raises(ValueError):
        g16.plan(4, 4096, 512, 8, 132, torch.float16)


def test_gather16_plan_at_t1024_gathers_each_weight_once():
    for _, out_f, in_f, g in B1_SHAPES[:6]:
        p = g16.plan(1024, out_f, in_f // g, g)
        assert p.gathers_per_weight == 1 and p.bm == 256 and p.splits == 1


def _phases_conflict_free(slots_by_lane, addr_by_lane):
    """One wavefront per quarter warp: distinct 16-byte slots, or equal addresses."""
    for q in range(4):
        lanes = range(8 * q, 8 * q + 8)
        seen = {}
        for ln in lanes:
            s, a = slots_by_lane[ln], addr_by_lane[ln]
            if s in seen and seen[s] != a:
                return False
            seen[s] = a
    return True


def test_gather16_gemv_pair_x_reads_are_conflict_free():
    """The g=16 kernel's staged bf16 x: lane (pair l, half h) reads unit
    (c*128 + 8l + j) * 2 + h of a row, padded by one unit in every 8 (the
    kernel's x_unit); every read of every chunk step is one wavefront a phase."""
    for c in range(3):
        for j in range(8):
            addr = []
            for lane in range(32):
                u = (c * 128 + 8 * (lane // 2) + j) * 2 + lane % 2
                addr.append(u + u // 8)
            assert _phases_conflict_free([a % 8 for a in addr], addr)


@pytest.mark.parametrize("g,x_bytes", [(8, 2), (8, 4), (16, 2), (16, 4)])
def test_gather16_gemv_first_design_x_reads_are_conflict_free(g, x_bytes):
    """The first design (g=8, and g=16 past 4 rows; unchanged): lane l reads
    its group j's GU units at (b*32 + l) * (8 GU + 1) + j GU + u."""
    gu = g * x_bytes // 16
    for j in range(8):
        for u in range(gu):
            addr = [lane * (8 * gu + 1) + j * gu + u for lane in range(32)]
            assert _phases_conflict_free([a % 8 for a in addr], addr)


def test_gather16_gemv_f32_g16_reads_meet_at_most_twice():
    """f32 x at g=16 (on no path: decode runs bf16) puts two lanes of a phase
    in one slot: two wavefronts, as the kernel's comment on x_unit says."""
    ch, worst = 128, 0
    for j in range(8):
        addr = []
        for lane in range(32):
            u = ((ch + 8 * (lane // 2) + j) * 2 + lane % 2) * 2
            addr.append(u + u // 16)
        for q in range(4):
            slots = [addr[ln] % 8 for ln in range(8 * q, 8 * q + 8)]
            worst = max(worst, max(slots.count(s) for s in slots))
    assert worst <= 2


@pytest.mark.parametrize("g", [8, 16])
def test_gather16_prepass_stores_are_coalesced(g):
    """The pre-pass: lane i of a block writes 16-byte unit u0 + i of W (and
    reads code (u0 + i) / LPC), so a warp's store is 512 contiguous bytes and
    a lane pair at g=16 reads one code's two halves."""
    lpc = g // 8
    for k in range(8):  # the unrolled units of a thread, 256 apart
        u = [k * 256 + lane for lane in range(32)]
        assert [x * 16 for x in u] == list(range(u[0] * 16, u[0] * 16 + 512, 16))
        codes = [x // lpc for x in u]
        assert codes == sorted(codes) and len(set(codes)) == 32 // lpc


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", B15_SHAPES, ids=lambda s: s[0])
def test_onehot_plan_fits_and_covers(shape, rows, K):
    _, out_f, in_f = shape
    ig = in_f // 8
    for dt in _b1_dtypes(rows):
        p = k15.onehot_plan(rows, out_f, ig, K, 132, 256, dt)
        assert p.smem <= k15.SMEM_LIMIT
        col_blocks = -(-out_f // 128)
        if rows <= 8:
            assert p.path == "gemv" and p.bm == 0 and p.groups_per_split % 32 == 0
            assert 1 <= p.stages <= 4 and p.stages <= p.groups_per_split // 32
            assert p.xg % 8 == 4 and p.xg >= min(p.groups_per_split, -(-ig // 32) * 32)
            assert p.smem == k15.onehot_gemv_smem(K, 256, p.stages, rows, p.xg, dt == torch.float32)
            assert p.grid == (col_blocks, 1, p.splits)
            unit = 32
        else:
            assert p.path == "gemm" and p.bm == (128 if rows <= 128 else 256)
            assert p.smem == k15.onehot_gemm_smem(p.bm, K, 256, p.stages)
            assert p.grid == (col_blocks, -(-rows // p.bm), p.splits)
            assert p.groups_per_split % 8 == 0
            if p.splits > 1:
                assert col_blocks * p.grid[1] < 132  # split only where tiles leave SMs idle
            unit = 8
        assert (p.splits - 1) * p.groups_per_split < ig <= p.splits * p.groups_per_split
        groups = [gi for z in range(p.splits)
                  for gi in range(z * p.groups_per_split, min(ig, (z + 1) * p.groups_per_split))]
        assert groups == list(range(ig))  # every input group once
        assert p.groups_per_split % unit == 0
        # every output column once, over the column blocks and the 16 column
        # chunks of the GEMV's lanes (column 16 v_chunk(g) + 8 h + m)
        if rows <= 8:
            chunk = [((g & 1) << 2) | (g >> 1) for g in range(8)]
            cols = sorted(b * 128 + 16 * chunk[g] + 8 * h + m for b in range(col_blocks)
                          for g in range(8) for h in range(2) for m in range(8))
            assert cols[:out_f] == list(range(out_f))
        ps = p.partials_shape(rows, out_f)
        assert ps is None if p.splits == 1 else ps[0] == p.splits


def test_onehot_plan_splits_kv_to_fill_the_card():
    p = k15.onehot_plan(4, 64, 4544 // 8, 2)
    assert p.splits == 18 and p.grid == (1, 1, 18)
    p = k15.onehot_plan(1024, 64, 4544 // 8, 2)
    assert p.splits > 1 and p.bm == 256


def test_onehot_plan_refuses():
    for args in ((4, 4544, 568, 9), (4, 4544, 568, 0), (0, 4544, 568, 2), (4, 0, 568, 2)):
        with pytest.raises(ValueError):
            k15.onehot_plan(*args)
    with pytest.raises(ValueError):
        k15.onehot_plan(4, 4544, 568, 2, 132, 257)
    with pytest.raises(ValueError):
        k15.onehot_plan(9, 4544, 568, 2, 132, 256, torch.float32)


def _chunk(g):
    return ((g & 1) << 2) | (g >> 1)


def test_onehot_gemv_code_reads_are_conflict_free():
    """Thread (g, t) reads the 16 codes of columns 16 v_chunk(g) .. +16 of its
    group (row R = k*32 + 4*step + t of the stage) through TMA's 128-byte
    swizzle (16-byte chunk c of row R at c ^ (R % 8)): one wavefront a phase."""
    for k in range(8):
        for step in range(8):
            addr = []
            for lane in range(32):
                g, tt = lane >> 2, lane & 3
                R = k * 32 + step * 4 + tt
                addr.append(R * 8 + (_chunk(g) ^ (R & 7)))
            assert _phases_conflict_free([a % 8 for a in addr], addr)


@pytest.mark.parametrize("xg", [36, 100, 292])
def test_onehot_gemv_x_reads_are_conflict_free(xg):
    """Thread (g, t) reads x row g's group 4*step + t: rows xg = 4 (mod 8)
    16-byte units apart."""
    for base in range(4):
        for step in range(8):
            addr = [base + (lane >> 2) * xg + step * 4 + (lane & 3) for lane in range(32)]
            assert _phases_conflict_free([a % 8 for a in addr], addr)


def test_onehot_gemv_byte_path_stores_fill_each_row_once():
    """OUT % 16 != 0: lane l stores bytes 4l .. 4l+3 of a 128-byte row into
    its swizzled place: one row a store, each byte once, one wavefront a
    phase (the 4-byte stores of a phase lie in 32 contiguous bytes... of
    whole 16-byte chunks)."""
    for R in range(16):
        where = []
        for lane in range(32):
            c = lane * 4
            where.extend(R * 128 + (((c >> 4) ^ (R & 7)) << 4) + (c & 15) + b for b in range(4))
        assert sorted(where) == list(range(R * 128, R * 128 + 128))


def test_onehot_gemm_wt_stores_are_conflict_free():
    """The GEMM's dequantisers (96 threads, six entries in flight each) store
    entry en = (group en >> 7, column en & 127) at core matrix (n / 8, group):
    byte ((n >> 3) * 8 + gl) * 128 + (n & 7) * 16, consecutive lanes on
    consecutive entries: one wavefront a phase."""
    for e0 in range(0, 8 * 128, 32):
        addr = []
        for lane in range(32):
            en = e0 + lane
            gl, n = en >> 7, en & 127
            addr.append((((n >> 3) * 8 + gl) * 128 + (n & 7) * 16) // 16)
        assert _phases_conflict_free([a % 8 for a in addr], addr)


# --------------------------------------------------------------------------- parity at the plans' boundaries


def _step_close(got, want, steps):
    g, w = f32(got), f32(want)
    assert np.all(np.abs(g - w) <= steps * 2.0 ** -7 * np.abs(w) + 1e-3 * np.abs(w).max())


@pytest.mark.parametrize("rows", [8, 9, 128, 129])
@pytest.mark.parametrize("group", [8, 16])
def test_gather16_plain_matches_jax_at_plan_boundaries(group, rows):
    """Rows 8/9 (GEMV/GEMM), 128/129 (BM 128/256): codes over 0..65535."""
    out_f, in_f = 136, 512
    rng = np.random.default_rng(rows + group)
    codes = rng.integers(0, 65536, (out_f, in_f // group)).astype(np.uint16)
    packed = jg.pack_codebook_rows(jnp.asarray(rng.standard_normal((65536, group)), jnp.float32),
                                   group)
    scales = rng.uniform(0.5, 1.5, out_f).astype(np.float32)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    tcodes = g16.codes16(torch.from_numpy(codes))
    for dt in (jnp.bfloat16, jnp.float32) if rows <= 8 else (jnp.bfloat16,):
        jx = jnp.asarray(x, dt)
        want = jg.gather_matmul_16(jx, jnp.asarray(codes), packed, jnp.asarray(scales), group=group)
        got = g16.plain(t(jx), tcodes, t(packed), t(scales), group)
        if dt == jnp.bfloat16:
            _step_close(got, want, 1)
        else:
            np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                       atol=1e-5 * np.abs(f32(want)).max())


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("rows", [8, 9, 128, 129])
@pytest.mark.parametrize("out_f", [64, 96, 200])
def test_onehot_plain_matches_jax_at_plan_boundaries(out_f, rows, K):
    """Rows 8/9 (GEMV/GEMM), 128/129 (BM 128/256), K 1/2/8, IN 200 (IG 25:
    a ragged last stage and slab)."""
    in_f = 200
    rng = np.random.default_rng(out_f + rows + K)
    codes = rng.integers(0, 256, (K, in_f // 8, out_f), dtype=np.uint8)
    jcb = jnp.asarray(rng.standard_normal((K, 256, 8)) / (4 * K ** 0.5), jnp.bfloat16)
    scales = rng.uniform(0.5, 1.5, out_f).astype(np.float32)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    for dt in (jnp.bfloat16, jnp.float32) if rows <= 8 else (jnp.bfloat16,):
        jx = jnp.asarray(x, dt)
        want = jk.fused_onehot_matmul(jx, jnp.asarray(codes), jcb, jnp.asarray(scales), group=8)
        got = k15.plain(t(jx), t(codes), t(jcb), t(scales))
        if dt == jnp.bfloat16:
            _step_close(got, want, 2)
        else:
            np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                       atol=1e-5 * np.abs(f32(want)).max())
