"""The int8 (W8A16) and int4 (W4A16) forward kernels' launch plans
(``int8_matmul.plan``, ``int4_matmul.plan``), Python models of their
prefill GEMMs' shared-memory stores and layouts, and their plain versions
against aqlm_tpu's interpret-mode kernels at the prefill row counts, on the
CPU.

The plans are pure functions of the shapes, so a launch that would need more
shared memory than a block may use, leave a split empty, miss an output tile
or let two lanes of a shared-memory phase meet on a bank fails here and not
first on the card. The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerance of the plain versions against JAX's bf16 outputs: one bf16 step,
2^-7 |ref| + 1e-3 max|ref| (each side rounds an f32 sum taken in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import int4_matmul as j4
from aqlm_tpu.ops import int8_matmul as jim
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im

# (name, OUT, IN, experts): Llama-2-7B's fused qkv, o, fused gate/up, down
# and lm_head, Mixtral-8x7B's all-expert gate/up and down, Falcon-7B's q, k
# (OUT 64), fc1 and fc2, and the card tests' ragged OUT over a padded IN
SHAPES = [("qkv", 12288, 4096, 1), ("o", 4096, 4096, 1), ("gate_up", 22016, 4096, 1),
          ("down", 4096, 11008, 1), ("lm_head", 32000, 4096, 1),
          ("mixtral_gate_up", 14336, 4096, 8), ("mixtral_down", 4096, 14336, 8),
          ("falcon_q", 4544, 4544, 1), ("falcon_k", 64, 4544, 1), ("falcon_fc1", 18176, 4544, 1),
          ("falcon_fc2", 4544, 18176, 1), ("card_ragged", 520, 1040, 3)]
ROWS = [1, 8, 9, 64, 65, 200, 256, 257, 1024]


def _check_cover(p, T, out_f, in_f, experts, unit):
    """The blocks cover every output tile and every contraction column once."""
    assert (p.splits - 1) * p.per_split < in_f <= p.splits * p.per_split  # no empty split
    assert p.per_split % unit == 0
    assert isinstance(p, im.Plan)  # (column tiles, row tiles, experts x splits)
    col_tiles, row_tiles, z = p.grid
    assert z == experts * p.splits
    assert (col_tiles - 1) * 128 < out_f <= col_tiles * 128
    assert (row_tiles - 1) * p.bm < T <= row_tiles * p.bm
    shape = p.partials_shape(T, out_f, experts)
    assert (shape is None) == (p.splits == 1)
    if shape is not None:
        assert shape[:2] == (experts, p.splits) and shape[2] >= T and shape[3] == out_f


@pytest.mark.parametrize("T", ROWS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_int8_plan_fits_and_covers(shape, T):
    _, out_f, in_f, experts = shape
    p = im.plan(T, out_f, in_f, im.pad_in_features(in_f), experts, 132)
    if T <= 8:  # at 1-2 rows a block a 16-row tile, else one block an SM (at most one a
        # tile), each a run of whole tiles over the whole contraction
        # (tests/test_torch_int8_gemv_plan.py models the rest)
        tiles = experts * -(-out_f // 16)
        if T <= 2:
            assert p == im.GemvPlan(tiles, 0, 0, "rows")
            return
        assert isinstance(p, im.GemvPlan) and p.blocks == min(132, tiles)
        assert p.smem <= im.T_SMEM_LIMIT and p.runs >= 1
        assert (p.runs, p.smem) == im.gemv_layout(T, in_f, tiles, p.blocks)
        return
    assert isinstance(p, im.Plan)
    assert p.bm == (64 if T <= 64 else 128 if T <= 256 else 256)
    assert 2 <= p.stages <= 8
    assert p.smem == im.gemm_t_smem(p.bm, p.stages) <= im.T_SMEM_LIMIT
    if p.bm == 64:
        assert p.smem <= im.TWO_BLOCKS_SMEM  # two blocks share an SM
    _check_cover(p, T, out_f, in_f, experts, 64)
    tiles = experts * p.grid[0] * p.grid[1]
    if p.splits > 1:  # only where the output tiles leave SMs idle
        assert tiles < 132 * (2 if p.bm == 64 else 1)


@pytest.mark.parametrize("T", ROWS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_int4_plan_fits_and_covers(shape, T):
    _, out_f, in_f, experts = shape
    ldb = i4.pad_in_features_int4(in_f) // 2
    p = i4.plan(T, out_f, in_f, ldb, experts, 132)
    if T <= 8:  # one block an SM (at most one a 16-row tile), each a run of whole tiles, the
        # activations staged in one run where the whole contraction fits
        tiles = experts * -(-out_f // 16)
        assert isinstance(p, i4.GemvPlan) and p.blocks == min(132, tiles)
        whole = 16384 + 16 * (8 + -(-in_f // 4096) * T * 528)  # each warp's barrier and columns
        assert p.smem <= im.T_SMEM_LIMIT and (p.runs == 1) == (whole <= im.T_SMEM_LIMIT)
        assert (p.runs, p.smem) == i4.gemv_layout(T, in_f, tiles, p.blocks)
        return
    _check_cover(p, T, out_f, in_f, experts, 256)
    assert isinstance(p, im.Plan) and p.bm == (64 if T <= 64 else 128) and 4 <= p.stages <= 8
    assert p.smem == i4.gemm_smem(p.bm, p.stages) <= im.T_SMEM_LIMIT
    if p.splits > 1:
        assert experts * p.grid[0] * p.grid[1] < 132


def test_plans_split_short_prompts_not_long_ones():
    """Narrow projections at short prompts split the contraction to fill the
    card; T=1024 at Llama-2-7B's and Mixtral's widths never does."""
    assert im.plan(64, 4096, 11008, 11264).splits > 1
    assert im.plan(64, 64, 4544, 5120).splits > 1
    assert i4.plan(64, 4096, 11008, 5632).splits > 1
    for out_f, in_f, e in ((12288, 4096, 1), (4096, 11008, 1), (32000, 4096, 1),
                           (14336, 4096, 8), (4096, 14336, 8)):
        assert im.plan(1024, out_f, in_f, im.pad_in_features(in_f), e).splits == 1
        assert i4.plan(1024, out_f, in_f, i4.pad_in_features_int4(in_f) // 2, e).splits == 1


def test_plans_keep_the_decode_split():
    """Neither decode GEMV splits the contraction over blocks. int8 at 1-2
    rows: a block a 16-row tile; past them, and int4, one block an SM walks
    whole tiles, its activations staged in shared memory whole, but where
    they do not fit beside the int8 GEMV's weight rings (Llama's down at 4-8
    rows, Mixtral's per-expert down at 3-8) or alone (int4: Mixtral's down
    at 7-8 rows), staged in runs."""
    p = im.plan(4, 4096, 4096, 4096)
    assert isinstance(p, im.GemvPlan) and (p.blocks, p.runs) == (132, 1)
    assert (im.plan(3, 4096, 11008, 11264).runs, im.plan(8, 4096, 11008, 11264).runs) == (1, 3)
    assert im.plan(1, 14336, 4096, 4096, 8) == im.GemvPlan(8 * 896, 0, 0, "rows")
    assert (im.plan(3, 4096, 14336, 14336, 8).runs, im.plan(8, 4096, 14336, 14336, 8).runs) == (2, 4)
    p = i4.plan(4, 4096, 11008, 5632)
    assert isinstance(p, i4.GemvPlan) and (p.blocks, p.runs) == (132, 1)
    assert isinstance(i4.plan(1, 14336, 4096, 2048, 8), i4.GemvPlan)
    assert i4.plan(8, 4096, 11008, 5632).runs == 1
    assert i4.plan(8, 4096, 14336, 7168, 8).runs == 2


@pytest.mark.parametrize("bad", [dict(T=0), dict(in_features=1000), dict(ld=1032),
                                 dict(in_features=8192), dict(experts=0), dict(out_features=0)])
def test_int8_plan_refuses_what_the_kernel_cannot_run(bad):
    args = dict(T=64, out_features=256, in_features=1024, ld=1024) | bad
    with pytest.raises(ValueError):
        im.plan(**args)


@pytest.mark.parametrize("bad", [dict(T=0), dict(in_features=1000), dict(ldb=200),
                                 dict(in_features=4096), dict(experts=0)])
def test_int4_plan_refuses_what_the_kernel_cannot_run(bad):
    args = dict(T=64, out_features=256, in_features=1024, ldb=512) | bad
    with pytest.raises(ValueError):
        i4.plan(**args)


# ---------------------------------------------------------------------------
# models of the prefill GEMMs' shared-memory traffic (csrc/int8_matmul.cu's
# widen_unit, csrc/int4_matmul.cu's dq_unit): a unit reads 16 bytes of a
# slab row and writes two 16-byte rows of W^T core matrices
# ---------------------------------------------------------------------------


def _widen_unit(u):
    p, q = u >> 3, u & 7
    return (p >> 2) * 8 + q, ((q >> 1) + p) & 3


def _dq_unit(u):
    return (u >> 5) * 8 + (u & 7), (u >> 3) & 3


def _core_row(n, kb):
    """Byte offset of W^T's 16-byte row (channel n, inputs 8 kb .. 8 kb + 7):
    K-major core matrices (n / 8, kb), 128 bytes each, eight along a 64-wide
    slab."""
    return ((n >> 3) * 8 + kb) * 128 + (n & 7) * 16


def _phases(n_units=512):
    return [range(first, first + 8) for first in range(0, n_units, 8)]


def test_int8_widening_covers_the_slab_and_is_conflict_free():
    """Each (row, chunk) of the [128 x 64] int8 slab is widened once; in each
    16-byte phase (8 lanes) the reads (64-byte rows) and both stores meet
    eight bank groups."""
    assert sorted(_widen_unit(u) for u in range(512)) == [(n, k) for n in range(128)
                                                         for k in range(4)]
    for lanes in _phases():
        units = [_widen_unit(u) for u in lanes]
        assert len({(n * 64 + kp * 16) // 16 % 8 for n, kp in units}) == 8
        for h in range(2):
            assert len({_core_row(n, 2 * kp + h) // 16 % 8 for n, kp in units}) == 8


def _swizzle128(n, chunk):
    """Where TMA's 128-byte swizzle puts 16-byte chunk `chunk` of 128-byte row n."""
    return n * 128 + (chunk ^ (n & 7)) * 16


@pytest.mark.parametrize("jj", range(4))
def test_int4_unpacking_covers_the_slab_and_is_conflict_free(jj):
    """For each quarter jj of a packing block (bytes 64 (jj % 2) ..), each
    (row, chunk) is unpacked once; the reads of the swizzled slab and both
    stores of each phase meet eight bank groups."""
    assert sorted(_dq_unit(u) for u in range(512)) == [(n, k) for n in range(128)
                                                      for k in range(4)]
    for lanes in _phases():
        units = [_dq_unit(u) for u in lanes]
        assert len({_swizzle128(n, (jj & 1) * 4 + kp) // 16 % 8 for n, kp in units}) == 8
        for h in range(2):
            assert len({_core_row(n, 2 * kp + h) // 16 % 8 for n, kp in units}) == 8


def _bf16(bits):
    """The float value of bf16 bit patterns (uint16 array)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def test_exact_int8_and_nibble_to_bf16():
    """s8x4_to_bf16x2: bf16(0x4300 | (w & 0x7f)) - bf16(0x4300 | (w & 0x80))
    is the signed byte, for every byte; nib4_to_bf16x2: bf16(0x4300 | q) - 136
    is q - 8 for every nibble. Both operands and results are exact bf16
    values, so the bf16 subtraction is exact."""
    w = np.arange(256, dtype=np.uint16)
    got = _bf16(0x4300 | (w & 0x7F)) - _bf16(0x4300 | (w & 0x80))
    np.testing.assert_array_equal(got, w.astype(np.uint8).view(np.int8).astype(np.float32))
    q = np.arange(16, dtype=np.uint16)
    np.testing.assert_array_equal(_bf16(0x4300 | q) - 136.0, q.astype(np.float32) - 8)


def _read_core(buf, n, kb):
    return buf[_core_row(n, kb):_core_row(n, kb) + 16].view(np.uint16)


def test_int8_widening_layout_round_trips():
    """The widening model writes W^T core matrices whose (channel, input)
    element is w8[channel, input] of the slab."""
    rng = np.random.default_rng(0)
    w8 = rng.integers(-128, 128, (128, 64), dtype=np.int8)
    sw = w8.view(np.uint8).reshape(-1)  # the TMA slab: 64-byte rows
    buf = np.zeros(128 * 64 * 2, np.uint8)
    for u in range(512):
        n, kp = _widen_unit(u)
        src = sw[n * 64 + kp * 16:n * 64 + kp * 16 + 16].astype(np.uint16)
        bits = ((0x4300 | (src & 0x7F)).astype(np.uint32) << 16).view(np.float32) - \
            ((0x4300 | (src & 0x80)).astype(np.uint32) << 16).view(np.float32)
        bf = (bits.view(np.uint32) >> 16).astype(np.uint16)  # exact, so truncation is exact
        for h in range(2):
            off = _core_row(n, 2 * kp + h)
            buf[off:off + 16] = bf[8 * h:8 * h + 8].view(np.uint8)
    got = np.array([[_bf16(_read_core(buf, n, kb)) for kb in range(8)] for n in range(128)])
    np.testing.assert_array_equal(got.reshape(128, 64), w8.astype(np.float32))


def test_int4_unpacking_layout_round_trips_against_unpack_int4():
    """The unpacking model, over TMA's swizzled copy of one packing block of
    each row, writes four W^T slabs whose (channel, input) element is
    q - 8 of column 64 jj + input of the block, as ``unpack_int4`` reads it:
    low nibbles are group 2i's columns in order, high nibbles group 2i + 1's.
    No contraction permutation."""
    rng = np.random.default_rng(1)
    w4 = rng.integers(0, 256, (128, 256), dtype=np.uint8)  # two packing blocks a row
    want = (i4.unpack_int4(torch.from_numpy(w4)).reshape(128, 512) - 8).numpy().astype(np.float32)
    for blk in range(2):
        smem = np.zeros(128 * 128, np.uint8)  # TMA: row n's chunk c at c ^ (n % 8)
        for n in range(128):
            for c in range(8):
                smem[_swizzle128(n, c):_swizzle128(n, c) + 16] = \
                    w4[n, blk * 128 + c * 16:blk * 128 + c * 16 + 16]
        for jj in range(4):
            buf = np.zeros(128 * 64 * 2, np.uint8)
            for u in range(512):
                n, kp = _dq_unit(u)
                off = _swizzle128(n, (jj & 1) * 4 + kp)
                q = (smem[off:off + 16] >> (4 * (jj >> 1))) & 0xF
                bf = ((_bf16(0x4300 | q.astype(np.uint16)) - 136.0).view(np.uint32) >> 16)
                bf = bf.astype(np.uint16)
                for h in range(2):
                    o = _core_row(n, 2 * kp + h)
                    buf[o:o + 16] = bf[8 * h:8 * h + 8].view(np.uint8)
            got = np.array([[_bf16(_read_core(buf, n, kb)) for kb in range(8)]
                            for n in range(128)]).reshape(128, 64)
            cols = blk * 256 + jj * 64
            np.testing.assert_array_equal(got, want[:, cols:cols + 64])


# ---------------------------------------------------------------------------
# the plain versions against aqlm_tpu at the prefill row counts
# ---------------------------------------------------------------------------

OUT, IN, E = 136, 1040, 3  # OUT ragged against 128-channel tiles; IN pads to 2048


def _one_step(got, want):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max())


def _x(rng, shape):
    jx = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return jx, t(jx)


@pytest.mark.parametrize("rows", [9, 64, 65, 200])
def test_int8_plain_matches_jax_at_prefill_rows(rows):
    rng = np.random.default_rng(rows)
    w8 = rng.integers(-127, 128, (OUT, im.pad_in_features(IN)), dtype=np.int8)
    w8[:, IN:] = 0
    scale = (rng.uniform(0.5, 1.5, OUT) / (127 * IN ** 0.5)).astype(np.float32)
    jx, tx = _x(rng, (rows, IN))
    want = jim.int8_matmul(jx, jnp.asarray(w8), jnp.asarray(scale))
    got = im.plain(tx, t(w8), t(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, OUT)
    _one_step(got, want)


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [9, 64, 65])
def test_int8_moe_plain_matches_jax_at_prefill_rows(rows, per_expert):
    rng = np.random.default_rng(rows + 100 * per_expert)
    w8 = rng.integers(-127, 128, (E, OUT, im.pad_in_features(IN)), dtype=np.int8)
    w8[..., IN:] = 0
    scale = (rng.uniform(0.5, 1.5, (E, OUT)) / (127 * IN ** 0.5)).astype(np.float32)
    jx, tx = _x(rng, (E, rows, IN) if per_expert else (rows, IN))
    want = jim.int8_moe_matmul(jx, jnp.asarray(w8), jnp.asarray(scale))
    got = im.moe_plain(tx, t(w8), t(scale))
    assert got.shape == (E, rows, OUT)
    _one_step(got, want)


def _int4_weights(seed, experts):
    rng = np.random.default_rng(seed)
    packs = [j4.quantize_int4(jnp.asarray(rng.standard_normal((OUT, IN)), jnp.float32) * IN ** -0.5)
             for _ in range(experts)]
    return (np.stack([np.asarray(p[0]) for p in packs]),
            np.stack([np.asarray(p[1]) for p in packs]))


@pytest.mark.parametrize("rows", [9, 64, 65, 200])
def test_int4_plain_matches_jax_at_prefill_rows(rows):
    w4, gs = _int4_weights(rows, 1)
    jx, tx = _x(np.random.default_rng(rows), (rows, IN))
    want = j4.int4_matmul(jx, jnp.asarray(w4[0]), jnp.asarray(gs[0]))
    got = i4.plain(tx, t(w4[0]), t(gs[0]))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, OUT)
    _one_step(got, want)


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [9, 64, 65])
def test_int4_moe_plain_matches_jax_at_prefill_rows(rows, per_expert):
    w4, gs = _int4_weights(rows + 7, E)
    jx, tx = _x(np.random.default_rng(rows + 100 * per_expert),
                (E, rows, IN) if per_expert else (rows, IN))
    want = j4.int4_moe_matmul(jx, jnp.asarray(w4), jnp.asarray(gs))
    got = i4.moe_plain(tx, t(w4), t(gs))
    assert got.shape == (E, rows, OUT)
    _one_step(got, want)
