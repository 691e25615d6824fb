"""K1's launch plan (``lut_gemv.plan``) and B10's (``int8_matmul.plan_t``)
at every main-path shape, and both kernels' plain versions against
aqlm_tpu's interpret-mode kernels, on the CPU.

The plans are pure functions of the shapes, so a launch that would need more
shared memory than a block may use, leave a split empty, straddle two
projections or let two lanes of a shared-memory phase meet in a bank fails
here and not first on the card. The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerances: f32 against f32 within 1e-5 of max|ref| (sums in another order);
bf16 against JAX's bf16 output within one bf16 step, 2^-7 |ref| + 1e-3
max|ref| (each side rounds an f32 sum taken in another order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import int8_matmul as jim
from aqlm_tpu.ops import lut_gemv as jl
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops import lut_gemv as lg

# (name, projections' out_features, in_features, experts): Llama-2-7B's fused
# qkv, o, fused gate/up and down, Falcon-7B's fc1, Mixtral-8x7B's all-expert
# gate/up and down, GQA-like unequal projections, and the card tests' shapes
K1_SHAPES = [("qkv", (4096, 4096, 4096), 4096, 1), ("o", (4096,), 4096, 1),
             ("gate_up", (11008, 11008), 4096, 1), ("down", (4096,), 11008, 1),
             ("falcon_fc1", (18176,), 4544, 1), ("mixtral_gate_up", (14336,), 4096, 8),
             ("mixtral_down", (4096,), 14336, 8), ("card_128_128", (128, 128), 1024, 1),
             ("gqa_qkv", (4096, 1024, 1024), 4096, 1),
             ("card_256", (256,), 4096, 1), ("card_moe", (256,), 2048, 3),
             ("card_ragged", (1152, 1152), 512, 1), ("card_moe_ragged", (2176,), 512, 8)]


def _k1_plan(sizes, in_f, experts, B, K):
    tn = min(lg.lut_tile_n(s) for s in sizes)
    return lg.plan(B, K, sum(sizes), in_f // 8, tn, len(sizes), experts, 132,
                   math.gcd(*sizes)), tn


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=lambda s: s[0])
def test_k1_plan_fits_covers_and_keeps_projections(shape, B, K):
    _, sizes, in_f, experts = shape
    p, tn = _k1_plan(sizes, in_f, experts, B, K)
    out_f, n_groups = sum(sizes), in_f // 8
    assert p.smem == lg.smem_bytes(p.cols, p.bp, p.stages, K) <= lg.SMEM_LIMIT
    assert p.cols in (256, 512)
    if K <= 2:
        assert p.smem <= 115712  # two blocks share an SM
    assert p.bp >= B and p.bp in (1, 2, 4, 8) and p.group_block * p.bp == 16
    assert p.tables * p.bp * 4 == 128  # one table row of a chunk: 32 floats
    assert 2 <= p.stages <= 6
    n_gb = -(-n_groups // p.group_block)
    assert (p.splits - 1) * p.gb_per_split < n_gb <= p.splits * p.gb_per_split  # none empty
    assert p.grid == (out_f // p.proj_width * p.blocks_per_proj, p.splits, experts)
    assert p.proj_width % 128 == 0 and out_f % p.proj_width == 0
    assert (p.blocks_per_proj - 1) * p.cols < p.proj_width <= p.blocks_per_proj * p.cols
    # the blocks write every column once, and each block's columns lie in one projection
    bounds = np.cumsum((0,) + sizes)
    written = [c for b in range(p.grid[0]) for c in p.block_columns(b)]
    assert sorted(written) == list(range(out_f))
    for b in range(p.grid[0]):
        cols = p.block_columns(b)
        assert np.searchsorted(bounds, cols[0], "right") == np.searchsorted(bounds, cols[-1], "right")
    # the code vectors of a phase's lanes (one per phase: its lanes share
    # them) cover the block's columns once
    cols = sorted(c + i for lane in range(0, 32, p.phase_lanes) for c in p.lookup_lane(lane)[2]
                  for i in range(p.colvec))
    assert cols == list(range(p.cols))


@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=lambda s: s[0])
def test_k1_lookup_phases_are_conflict_free(shape, B):
    """The lanes of each shared-memory phase of a lookup read distinct tables
    (and halves), which lie on distinct banks whatever the codes: a table
    row is 32 floats, and the lane's float within it is fixed."""
    _, sizes, in_f, experts = shape
    p, _ = _k1_plan(sizes, in_f, experts, B, 2)
    bh, phase = p.lookup_floats, p.phase_lanes
    rng = np.random.default_rng(B)
    for first in range(0, 32, phase):
        lanes = range(first, first + phase)
        tabs = [p.lookup_lane(lane)[:2] for lane in lanes]
        assert len(set(tabs)) == phase  # distinct (table, float)
        assert len({tab for tab, _ in tabs}) == min(phase, p.tables)
        for _ in range(8):  # banks of 4 * bh bytes: the same for any codes
            codes = rng.integers(0, 256, phase)
            banks = {((c * 32 + off) // bh) % (32 // bh) for c, (_, off) in zip(codes, tabs)}
            assert len(banks) == phase


def test_k1_table_stores_are_conflict_free():
    """Each of the build's store instructions (lane (gid, tig) writes source
    (i + tig) % 4 of its four to float gid + 8 ((i + tig) % 4) of its row)
    meets 32 banks."""
    for i in range(4):
        banks = {(lane // 4 + 8 * ((i + lane % 4) % 4)) % 32 for lane in range(32)}
        assert len(banks) == 32


@pytest.mark.parametrize("shape", K1_SHAPES[:7], ids=lambda s: s[0])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_k1_code_reads_are_conflict_free_on_the_main_path(shape, B):
    """A lane reads ``colvec`` codes of its table at once; code rows are
    padded by 16 bytes, so the lanes of a phase meet distinct banks or read
    the same bytes."""
    _, sizes, in_f, experts = shape
    p, _ = _k1_plan(sizes, in_f, experts, B, 2)
    cv, row = p.colvec, p.cols + 16
    phase = 128 // cv
    for first in range(0, 32, phase):
        addrs = {}
        for lane in range(first, first + phase):
            tab, _, firsts = p.lookup_lane(lane)
            a = tab * row + firsts[0]
            addrs.setdefault((a // cv) % phase, set()).add(a)
        assert all(len(v) == 1 for v in addrs.values())


def test_k1_plan_widths_and_splits():
    """Narrow dense projections split their input groups to fill the card;
    Mixtral's all-expert gate/up (224 blocks) does not. Gate and up (11008 =
    21.5 x 512) take 512-column blocks, the last of each projection cut at
    its end."""
    assert lg.plan(4, 2, 4096, 512, 512).splits > 1
    p = lg.plan(4, 2, 14336, 512, 512, 1, 8)
    assert (p.cols, p.splits, p.grid) == (512, 1, (28, 1, 8))
    p = lg.plan(4, 2, 22016, 512, 128, 2, 1, 132, 11008)
    assert (p.cols, p.proj_width, p.blocks_per_proj) == (512, 11008, 22)
    assert list(p.block_columns(21)) == list(range(10752, 11008))
    assert list(p.block_columns(22)) == list(range(11008, 11520))
    assert lg.plan(4, 2, 12288, 512, 512, 3, 1, 132, 4096).cols == 512


@pytest.mark.parametrize("bad", [dict(B=9), dict(K=9), dict(out_features=200), dict(tn=100),
                                 dict(n_groups=0)])
def test_k1_plan_refuses_what_the_kernel_cannot_run(bad):
    args = dict(B=4, K=2, out_features=512, n_groups=128, tn=128) | bad
    with pytest.raises(ValueError):
        lg.plan(**args)


# (OUT, IN_pad): the lora phase's q, gate and down, and OUT 11008 over 4096
B10_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11264), (200, 1008)]


@pytest.mark.parametrize("T", [1, 8, 9, 200, 256, 257, 1024])
@pytest.mark.parametrize("out_f,ld", B10_SHAPES)
def test_b10_plan_fits_and_covers(out_f, ld, T):
    p = im.plan_t(T, out_f, ld, 132)
    assert p.smem <= im.T_SMEM_LIMIT
    if T <= 8:
        assert p.path == "gemv" and p.bm == 0 and p.stages == 0
        assert p.tile == (512 if T <= 4 else 256)
        assert p.per_split % 32 == 0 and p.per_split <= 512
        assert (p.splits - 1) * p.per_split < out_f <= p.splits * p.per_split  # none empty
        assert p.grid == (-(-ld // p.tile), p.splits, 1)
        assert p.smem == im.gemv_t_smem(T, p.per_split)
        if -(-ld // p.tile) < 132 and out_f >= 64 * 32:  # fill the card twice where OUT allows
            assert p.grid[0] * p.grid[1] >= 2 * 132 * 0.9
    else:
        assert p.path == "gemm" and p.bm == p.tile
        assert p.tile == (256 if T > 256 else 128)
        n_slabs = -(-out_f // 64)
        assert (p.splits - 1) * p.per_split < n_slabs <= p.splits * p.per_split
        assert p.grid == (-(-ld // 128), -(-T // p.tile), p.splits)
        assert p.smem == im.gemm_t_smem(p.tile, p.stages)
        assert p.stages >= 2
        if p.splits > 1:
            assert p.grid[0] * p.grid[1] < 132  # only where the tiles leave SMs idle


def test_b10_plan_splits_short_not_long():
    assert im.plan_t(200, 4096, 4096).splits > 1
    assert im.plan_t(1024, 11008, 4096).splits == 1
    assert im.plan_t(1, 4096, 4096).splits > 1


@pytest.mark.parametrize("bad", [dict(T=0), dict(out_features=100), dict(ld=100)])
def test_b10_plan_refuses_what_the_kernel_cannot_run(bad):
    args = dict(T=8, out_features=256, ld=256) | bad
    with pytest.raises(ValueError):
        im.plan_t(**args)


def _one_step(got, want):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("g_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 200])
def test_int8_matmul_transposed_plain_matches_jax_at_b10_rows(rows, g_dtype):
    """B10's plain version against aqlm_tpu's kernel at the rows of both
    paths, bf16 and f32 g, IN padded (1152 -> 2048)."""
    rng = np.random.default_rng(rows)
    out_f, in_f = 264, 1152
    in_pad = im.pad_in_features(in_f)
    w8 = rng.integers(-127, 128, (out_f, in_pad), dtype=np.int8)
    w8[:, in_f:] = 0
    scale = (rng.uniform(0.5, 1.5, out_f) / 127).astype(np.float32)
    g = rng.standard_normal((rows, out_f)).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if g_dtype == "bf16" else jnp.float32)
    want = jim.int8_matmul_transposed(jg, jnp.asarray(w8), jnp.asarray(scale))
    got = im.int8_matmul_transposed(t(jg), torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, in_pad) == want.shape
    assert not f32(got)[:, in_f:].any()
    _one_step(got, want)


def _lut_inputs(rng, E, K, out_f, in_f):
    tn = lg.lut_tile_n(out_f)
    codes = rng.integers(0, 256, (E, out_f // tn, in_f // 8 * K, tn), dtype=np.uint8)
    cb = jnp.asarray(rng.standard_normal((E, K, 256, 8)) / (2 * K), jnp.bfloat16)
    scales = rng.uniform(0.5, 1.5, (E, out_f)).astype(np.float32)
    return codes, cb, scales


def _f32_close(got, want):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_lut_gemv_plain_matches_jax_at_k(K, rows):
    """K1's plain version against aqlm_tpu's interpret-mode LUT kernel (the
    table form: one f32 dot a group and codebook, then lookups), f32 x."""
    rng = np.random.default_rng(K * 10 + rows)
    codes, cb, scales = _lut_inputs(rng, 1, K, 256, 128)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    want = jl.lut_gemv_kx8_tiled(jnp.asarray(x), jnp.asarray(codes[0]), cb[0],
                                 jnp.asarray(scales[0]), group=8)
    got = lg.lut_gemv_kx8_tiled(t(x), t(codes[0]), t(cb[0]), t(scales[0]), group=8)
    assert got.dtype == torch.float32 and got.shape == (rows, 256)
    _f32_close(got, want)


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_lut_moe_gemv_plain_matches_jax_at_k(K, per_expert):
    """The all-expert form's plain version against aqlm_tpu's interpret-mode
    kernel, shared and per-expert x, f32."""
    rng = np.random.default_rng(K * 10 + per_expert)
    E, rows = 3, 4
    codes, cb, scales = _lut_inputs(rng, E, K, 256, 128)
    x = rng.standard_normal((E, rows, 128) if per_expert else (rows, 128)).astype(np.float32)
    want = jl.lut_moe_gemv_kx8(jnp.asarray(x), jnp.asarray(codes), cb, jnp.asarray(scales),
                               group=8)
    got = lg.lut_moe_gemv_kx8(t(x), t(codes), t(cb), t(scales), group=8)
    assert got.dtype == torch.float32 and got.shape == (E, rows, 256)
    _f32_close(got, want)
