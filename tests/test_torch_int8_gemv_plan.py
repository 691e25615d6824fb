"""The int8 (W8A16) decode GEMV's launch plan (``int8_matmul.plan`` at <= 8
rows, a ``GemvPlan``), Python models of its work split, its
thread-to-fragment mapping and its shared-memory reads, and the port's plain
versions against aqlm_tpu's interpret-mode kernels at the decode row counts,
on the CPU.

The plan is a pure function of the shapes, so a launch that would need more
shared memory than a block may use, leave a tile or a contraction column
uncovered, take one twice, pair a weight with another column's activation
or let two lanes of a shared-memory phase meet on a bank fails here and not
first on the card. The kernel itself runs only on the card
(tests/test_torch_cuda.py). The models mirror ``int8_gemv_kernel`` in
``csrc/int8_matmul.cu``, the tensor-core GEMV at 3-8 rows (1-2 rows take the
row kernel, a block a 16-row tile): warp w of run c takes piece q = 16 c + w
of the contraction's 64-column units; a thread reads bytes 64 seg + 16 tig
.. + 15 of each 256-column item of rows gid and gid + 8 back from its
warp's ring.

Tolerance of the plain versions against JAX's bf16 outputs: one bf16 step,
2^-7 |ref| + 1e-3 max|ref| (each side rounds an f32 sum taken in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import int8_matmul as jim
from aqlm_tpu_torch.ops import int8_matmul as im

SMS = 132
WARPS, UNIT, ITEM, STAGES, LIMIT = 16, 64, 256, 2, 232448
# (name, OUT, IN, experts): Llama-2-7B's fused qkv, o, fused gate/up, down
# and lm_head, Mixtral-8x7B's all-expert gate/up and down, Falcon-7B's q, k
# (OUT 64), fc1 and fc2, and the card tests' ragged OUT over a padded IN
SHAPES = [("qkv", 12288, 4096, 1), ("o", 4096, 4096, 1), ("gate_up", 22016, 4096, 1),
          ("down", 4096, 11008, 1), ("lm_head", 32000, 4096, 1),
          ("mixtral_gate_up", 14336, 4096, 8), ("mixtral_down", 4096, 14336, 8),
          ("falcon_q", 4544, 4544, 1), ("falcon_k", 64, 4544, 1), ("falcon_fc1", 18176, 4544, 1),
          ("falcon_fc2", 4544, 18176, 1), ("card_ragged", 520, 1040, 3)]


def _piece(q, n_units, pieces, in_f):
    """Columns [k0, k1) of piece q (the kernel's piece_of)."""
    return UNIT * (q * n_units // pieces), min(in_f, UNIT * ((q + 1) * n_units // pieces))


def _layout(T, in_f, tiles, blocks, chunks):
    """The kernel's GemvLayout at `chunks` runs: (largest piece, total bytes):
    the warps' sums (two buffers), the kept sums, the barriers, each warp's
    ring of 16 x 128-byte weight items, each warp's staged columns."""
    n_units = -(-in_f // UNIT)
    piece = -(-n_units // (WARPS * chunks)) * UNIT
    run = -(-tiles // blocks)
    park = run * 16 * 8 * 4 if chunks > 1 else 0
    ring = WARPS * STAGES * 16 * ITEM
    return piece, 2 * WARPS * 16 * 8 * 4 + park + WARPS * 8 + ring + WARPS * T * (2 * piece + 16)


@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_int8_gemv_plan_covers_every_tile_and_column_once(shape, T):
    """One block an SM (or a tile) walks a contiguous run of 16-row tiles,
    none empty; in run c warp w takes piece 16 c + w of the contraction in
    256-column items, a thread's 16-byte runs at 64 seg + 16 tig of each
    item read only inside the piece: every (expert, tile, column) once
    and each piece's columns once. The activations are staged in one run
    where the whole contraction fits, else in the fewest runs that fit, and
    the shared memory fits a block."""
    _, out_f, in_f, experts = shape
    p = im.plan(T, out_f, in_f, im.pad_in_features(in_f), experts, SMS)
    tiles = experts * -(-out_f // 16)
    if T <= im.GEMV_ROWS_MAX_ROWS:  # the row kernel: a block a tile over the whole contraction
        assert p == im.GemvPlan(tiles, 0, 0, "rows")
        return
    assert isinstance(p, im.GemvPlan) and p.form == "mma" and p.blocks == min(SMS, tiles)
    chunks = p.runs
    piece, total = _layout(T, in_f, tiles, p.blocks, chunks)
    assert (p.runs, p.smem) == im.gemv_layout(T, in_f, tiles, p.blocks)
    assert p.smem == total <= LIMIT
    if chunks > 1:  # one run fewer would not fit
        assert _layout(T, in_f, tiles, p.blocks, chunks - 1)[1] > LIMIT
    runs = [(b * tiles // p.blocks, (b + 1) * tiles // p.blocks) for b in range(p.blocks)]
    assert all(lo < hi for lo, hi in runs) and max(hi - lo for lo, hi in runs) == -(-tiles // p.blocks)
    n_units, pieces = -(-in_f // UNIT), WARPS * chunks
    cols = np.zeros(in_f, dtype=np.int64)
    bounds = []
    for q in range(pieces):
        k0, k1 = _piece(q, n_units, pieces, in_f)
        assert k1 - k0 <= piece and k0 % UNIT == 0 and k0 <= k1
        bounds.append((k0, k1))
        for j in range(-(-(k1 - k0) // ITEM)):
            for seg in range(ITEM // 64):
                for tig in range(4):
                    c = k0 + ITEM * j + 64 * seg + 16 * tig
                    if c < k1:  # a thread's 16-byte run: wholly inside the piece, or not read
                        assert c + 16 <= k1
                        cols[c:c + 16] += 1
    assert (cols == 1).all()
    seen = np.zeros((tiles, pieces), dtype=np.int64)
    for lo, hi in runs:  # every block takes every piece of each of its tiles once
        seen[lo:hi] += 1
    assert (seen == 1).all() and bounds[0][0] == 0 and bounds[-1][1] == in_f
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if in_f <= 4544:
        assert chunks == 1  # staged whole at every row count
    if (out_f, in_f) == (4096, 11008):  # Llama's down: runs at 4-8 rows
        assert chunks == (1 if T <= 3 else 2 if T <= 6 else 3)
    if (out_f, in_f, experts) == (4096, 14336, 8):  # Mixtral's down: runs at 3-8 rows
        assert chunks == (2 if T <= 5 else 3 if T <= 7 else 4)


def _a_fragment(gid, tig, seg, s):
    """Where thread (gid, tig)'s A registers of step (seg, s) come from: the
    kernel's s8x4_to_bf16x2 of word s of its segment's 16 bytes of rows gid
    (a0, a2) and gid + 8 (a1, a3); byte b of the word is item column 64 seg +
    16 tig + 4 s + b. Returns {(m, k): (weight row, item column)} by the
    m16n8k16 A layout: a0 (gid, 2 tig + h), a1 (gid + 8, 2 tig + h), a2
    (gid, 2 tig + 8 + h), a3 (gid + 8, 2 tig + 8 + h)."""
    j0 = 64 * seg + 16 * tig + 4 * s
    out = {}
    for row in (gid, gid + 8):
        for b in range(4):  # lo = bytes 0, 1 -> k 2 tig + b; hi = bytes 2, 3 -> k 2 tig + 8 + b - 2
            k = 2 * tig + b if b < 2 else 2 * tig + 8 + b - 2
            out[row, k] = (row, j0 + b)
    return out


def _b_fragment(gid, tig, seg, s):
    """Where thread (gid, tig)'s B registers of step (seg, s) come from: xv =
    its two 16-byte reads of staged row gid at item column 64 seg + 16 tig;
    b0 = word 2 (s & 1) of xv[s >> 1], b1 the next word. Returns {(k, n):
    (activation row, item column)} by the m16n8k16 B layout: b0 (2 tig + h,
    gid), b1 (2 tig + 8 + h, gid)."""
    base = 64 * seg + 16 * tig
    out = {}
    for reg, word in ((0, 2 * (s & 1)), (1, 2 * (s & 1) + 1)):
        for h in range(2):
            col = base + 8 * (s >> 1) + 2 * word + h
            out[2 * tig + 8 * reg + h, gid] = (gid, col)
    return out


def test_int8_gemv_fragments_pair_every_weight_with_its_column():
    """Over one 256-column item the 16 mma steps (4 segments x 4 words)
    give every (weight row m, activation row n) each item column exactly
    once, and in every product A[m][k] B[k][n] the weight's column is the
    activation's: the permutation of the contraction inside a step is the
    same on both operands, so x is staged in its natural order."""
    pairs = {}
    for seg in range(ITEM // 64):
        for s in range(4):
            A, B = {}, {}
            for lane in range(32):
                gid, tig = lane // 4, lane % 4
                for key, v in _a_fragment(gid, tig, seg, s).items():
                    assert key not in A
                    A[key] = v
                for key, v in _b_fragment(gid, tig, seg, s).items():
                    assert key not in B
                    B[key] = v
            assert sorted(A) == [(m, k) for m in range(16) for k in range(16)]
            assert sorted(B) == [(k, n) for k in range(16) for n in range(8)]
            for m in range(16):
                for n in range(8):
                    for k in range(16):
                        (wr, wc), (xr, xc) = A[m, k], B[k, n]
                        assert wr == m and xr == n and wc == xc
                        pairs[m, n, wc] = pairs.get((m, n, wc), 0) + 1
    assert len(pairs) == 16 * 8 * ITEM and set(pairs.values()) == {1}


def test_int8_gemv_sums_cover_the_tile_once():
    """The accumulators' element q of lane (gid, tig) is (row gid + 8 (q >> 1),
    activation row 2 tig + (q & 1)), as the m16n8k16 C layout puts them; the
    warps' sums' slots red[warp][row][b] are each written once a warp."""
    slots = sorted((gid + 8 * (q >> 1), 2 * tig + (q & 1))
                   for gid in range(8) for tig in range(4) for q in range(4))
    assert slots == [(r, b) for r in range(16) for b in range(8)]


def _swz(r):
    """The kernel's gv_swz: 16-byte chunk c of a staged item's row r lies at
    chunk c ^ _swz(r) of the row's 128 bytes."""
    return ((r & 1) << 2) | ((r >> 1) & 3)


def test_int8_gemv_weight_ring_copies_and_reads_meet_no_bank_twice():
    """An item of the warp's ring, 16 rows of 256 bytes: the cp.async copies
    (lane l: chunk l % 16 of row 2 i + l / 16; an instruction reads 256
    contiguous bytes of each of two rows) put each (row, chunk) in its own
    place and their phases (8 lanes: 128 contiguous bytes of one row) meet
    eight bank groups; the fragment reads (lane (gid, tig): chunk 4 seg +
    tig of rows gid and gid + 8) take every (row, chunk) once over the four
    segments and both rows, and each phase meets 32 distinct banks."""
    cpr = ITEM // 16
    places = set()
    for i in range(16 * cpr // 32):
        lanes = range(32)
        rows = [(32 // cpr) * i + l // cpr for l in lanes]
        for r in set(rows):  # each row's lanes read its 256 bytes in order
            assert [16 * (l % cpr) for l in lanes if rows[l] == r] == list(range(0, ITEM, 16))
        for phase in range(4):
            ph = range(8 * phase, 8 * phase + 8)
            assert len({rows[l] for l in ph}) == 1
            offs = [rows[l] * ITEM + 16 * ((l % cpr) ^ _swz(rows[l])) for l in ph]
            assert len({o // 16 % 8 for o in offs}) == 8
            places.update(offs)
    assert sorted(places) == list(range(0, 16 * ITEM, 16))
    read = []
    for seg in range(ITEM // 64):
        for plus8 in (0, 8):
            for phase in range(4):
                banks = []
                for lane in range(8 * phase, 8 * phase + 8):
                    gid, tig = lane // 4, lane % 4
                    r = gid + plus8
                    addr = r * ITEM + 16 * ((4 * seg + tig) ^ _swz(r))
                    read.append((r, 4 * seg + tig))
                    banks += [(addr // 4 + k) % 32 for k in range(4)]
                assert sorted(banks) == list(range(32)), (seg, plus8, phase)
    assert sorted(read) == [(r, c) for r in range(16) for c in range(ITEM // 16)]


def _staged_strides():
    """The staged activation row strides (2 x the largest piece + 16 bytes)
    of every plan at SHAPES' shapes and 1-8 rows."""
    out = set()
    for _, out_f, in_f, experts in SHAPES:
        for T in range(im.GEMV_ROWS_MAX_ROWS + 1, 9):
            p = im.plan(T, out_f, in_f, im.pad_in_features(in_f), experts, SMS)
            out.add(2 * _layout(T, in_f, experts * -(-out_f // 16), p.blocks, p.runs)[0] + 16)
    return sorted(out)


@pytest.mark.parametrize("xs", _staged_strides())
def test_int8_gemv_staged_x_reads_meet_no_bank_twice(xs):
    """A warp's 16-byte reads of its staged activation rows (row gid at gid
    x xs bytes, thread tig at 2 (128 j + 64 seg + 16 tig) bytes and 16 more):
    each quarter warp's eight lanes cover 32 distinct banks, at every item j
    of the largest piece."""
    assert xs % 32 == 16
    items = (xs - 16) // 2 // ITEM
    for j in range(max(1, items)):
        for seg in range(ITEM // 64):
            for second in (0, 16):
                for phase in range(4):
                    banks = []
                    for lane in range(8 * phase, 8 * phase + 8):
                        gid, tig = lane // 4, lane % 4
                        addr = gid * xs + 2 * (ITEM * j + 64 * seg + 16 * tig) + second
                        banks += [(addr // 4 + k) % 32 for k in range(4)]
                    assert sorted(banks) == list(range(32)), (xs, j, seg, phase)


def test_int8_gemv_plan_refuses_what_the_kernel_cannot_run():
    for bad in (dict(T=0), dict(in_features=1000), dict(ld=1032), dict(in_features=8192)):
        args = dict(T=4, out_features=256, in_features=1024, ld=1024) | bad
        with pytest.raises(ValueError):
            im.plan(**args)


# ---------------------------------------------------------------------------
# the plain versions against aqlm_tpu at the decode row counts
# ---------------------------------------------------------------------------

OUT, IN, E, L = 40, 1040, 3, 2  # OUT ragged against 16-row tiles; IN pads to 2048


def _one_step(got, want):
    w = f32(want)
    np.testing.assert_allclose(f32(got), w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max())


def _x(rng, shape):
    jx = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return jx, t(jx)


@pytest.mark.parametrize("rows", range(1, 9))
def test_int8_plain_matches_jax_indexed_at_decode_rows(rows):
    rng = np.random.default_rng(rows)
    w8 = rng.integers(-127, 128, (L, OUT, im.pad_in_features(IN)), dtype=np.int8)
    w8[..., IN:] = 0
    scale = (rng.uniform(0.5, 1.5, (L, OUT)) / (127 * IN ** 0.5)).astype(np.float32)
    jx, tx = _x(rng, (rows, IN))
    want = jim.int8_matmul_indexed(jx, jnp.asarray(w8), jnp.asarray(scale), 1)
    got = im.plain(tx, t(w8)[1], t(scale)[1])
    assert got.dtype == torch.bfloat16 and got.shape == (rows, OUT)
    _one_step(got, want)
    _one_step(im.int8_matmul_indexed(tx, t(w8), t(scale), 1), want)


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", range(1, 9))
def test_int8_moe_plain_matches_jax_indexed_at_decode_rows(rows, per_expert):
    rng = np.random.default_rng(rows + 100 * per_expert)
    w8 = rng.integers(-127, 128, (L, E, OUT, im.pad_in_features(IN)), dtype=np.int8)
    w8[..., IN:] = 0
    scale = (rng.uniform(0.5, 1.5, (L, E, OUT)) / (127 * IN ** 0.5)).astype(np.float32)
    jx, tx = _x(rng, (E, rows, IN) if per_expert else (rows, IN))
    want = jim.int8_moe_matmul_indexed(jx, jnp.asarray(w8), jnp.asarray(scale), 1)
    got = im.moe_plain(tx, t(w8)[1], t(scale)[1])
    assert got.shape == (E, rows, OUT)
    _one_step(got, want)
    _one_step(im.int8_moe_matmul_indexed(tx, t(w8), t(scale), 1), want)
