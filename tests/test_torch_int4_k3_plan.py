"""The int4 (W4A16) decode GEMV's and K3's row kernel's launch plans
(``int4_matmul.plan`` at <= 8 rows, ``flash_decode.row_plan``), Python
models of their work split and shared-memory reads, and the port's plain K3
and B6 computed with the row plan's splits against aqlm_tpu's interpret-mode
kernels, on the CPU.

The plans are pure functions of what the host knows, so a launch that would
need more shared memory than a block may use, leave a tile, a packing block
or a key uncovered, take one twice, or let two lanes of a shared-memory
phase meet on a bank fails here and not first on the card. The kernels
themselves run only on the card (tests/test_torch_cuda.py).

Tolerance of the plain versions against JAX's bf16 outputs: JAX's own bf16
rounding, 2^-8 |ref| + 1e-5 max|ref|, as tests/test_torch_split_kv.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import f32, t

from aqlm_tpu.ops import flash_decode as jfd
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im

SMS = 132
# (name, OUT, IN, experts): Llama-2-7B's o, down, fused qkv and gate/up and
# Mixtral-8x7B's all-expert gate/up (shared x) and down (per-expert x), and
# the card tests' ragged OUT over a padded IN
GEMV_SHAPES = [("o", 4096, 4096, 1), ("down", 4096, 11008, 1), ("qkv", 12288, 4096, 1),
               ("gate_up", 22016, 4096, 1), ("mixtral_gate_up", 14336, 4096, 8),
               ("mixtral_down", 4096, 14336, 8), ("ragged", 520, 1040, 3)]


@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("shape", GEMV_SHAPES, ids=lambda s: s[0])
def test_int4_gemv_plan_covers_every_tile_and_packing_block_once(shape, T):
    """One block an SM (or a tile) walks a contiguous run of 16-row tiles,
    none empty; the contraction is staged whole, or in the fewest equal runs
    of packing blocks that fit; within a tile and run warp w takes packing
    blocks w, w + 16, ...: every (expert, tile, packing block) once, and the
    shared memory fits a block."""
    _, out_f, in_f, experts = shape
    p = i4.plan(T, out_f, in_f, i4.pad_in_features_int4(in_f) // 2, experts, SMS)
    tiles = experts * -(-out_f // 16)
    n_pb = -(-in_f // 256)
    assert isinstance(p, i4.GemvPlan) and p.blocks == min(SMS, tiles)
    assert (n_pb - 1) * 256 < in_f <= n_pb * 256
    blocks, chunks = p.blocks, p.runs
    run = -(-tiles // blocks)

    def smem(n):  # the layout at n runs: sums, kept sums, each warp's barrier and columns
        pbc = -(-n_pb // n)
        return 16384 + (run * 512 if n > 1 else 0) + 16 * (8 + -(-pbc // 16) * T * 528)

    pbc = -(-n_pb // chunks)
    assert p.smem == smem(chunks) <= im.T_SMEM_LIMIT
    if chunks > 1:  # one run fewer would not fit
        assert smem(chunks - 1) > im.T_SMEM_LIMIT
    runs = [(b * tiles // blocks, (b + 1) * tiles // blocks) for b in range(blocks)]
    assert all(lo < hi for lo, hi in runs) and max(hi - lo for lo, hi in runs) == run
    seen = np.zeros((tiles, n_pb), dtype=np.int64)
    for lo, hi in runs:
        for c in range(chunks):
            n = min(n_pb, (c + 1) * pbc) - c * pbc
            for w in range(16):
                per_tile = -(-(n - w) // 16) if w < n else 0
                for t in range(lo, hi):
                    for j in range(per_tile):
                        seen[t, c * pbc + w + 16 * j] += 1
    assert (seen == 1).all()
    if (out_f, in_f, experts) == (4096, 14336, 8):
        assert chunks == (2 if T >= 7 else 1)  # 7-8 rows of 14336 columns take two runs


def test_int4_gemv_staged_x_reads_meet_no_bank_twice():
    """A warp's 16-byte reads of its staged activation columns (rows gid < 8
    of 528 bytes, thread tig at 32 tig and 32 tig + 16 bytes into its
    32-column step group): each quarter warp's eight lanes cover 32
    distinct banks."""
    for slot_base in (0, 8 * 528, 3 * 8 * 528):
        for half in (0, 1):
            for seg in (0, 1):
                for second in (0, 16):
                    for phase in range(4):
                        banks = []
                        for lane in range(8 * phase, 8 * phase + 8):
                            gid, tig = lane // 4, lane % 4
                            addr = (slot_base + gid * 528 + 2 * (128 * half + 64 * seg + 16 * tig)
                                    + second)
                            banks += [(addr // 4 + k) % 32 for k in range(4)]
                        assert sorted(banks) == list(range(32)), (slot_base, half, seg, phase)


# (model, B, kv heads, query heads per kv head, head_dim): K3's decode shapes
K3_SHAPES = [("llama2_7b", 4, 32, 1, 128), ("llama2_7b_b1", 1, 32, 1, 128),
             ("mixtral_8x7b", 4, 8, 4, 128), ("rep2", 4, 16, 2, 128), ("rep8_d64", 2, 4, 8, 64)]


def _blocks_of_row(kps, splits, window, pos):
    """The key ranges of a K3 row's blocks z = 0 .. splits - 1 (the kernel's
    k0, k1: kps keys from the row's first key), its first and end keys and
    its count of splits holding keys."""
    kend = pos + 1
    kstart = max(0, kend - window) if window else 0
    ranges = [(kstart + z * kps, min(kend, kstart + (z + 1) * kps)) for z in range(splits)]
    return ranges, kstart, kend, -(-(kend - kstart) // kps)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: s[0])
def test_k3_row_plan_covers_every_key_once(shape, quant, window):
    """At every offset of a 2048-row cache the row's blocks hold its keys
    in whole splits of kps keys, each key once; the splits holding keys are
    the first n_act of the grid's (the merge reads those), none of them
    empty; the grid stays within the plan's bound and the shared memory
    keeps three blocks an SM."""
    _, b, hkv, rep, d = shape
    S = 2048
    p = fd.row_plan(b, hkv, rep, d, S, quant, window, sm_count=SMS)
    assert p.kps in fd.ROW_KPS and p.smem == fd.row_smem(p.kps, d, rep, quant, p.splits)
    assert p.smem <= 232448
    if window is None:  # three blocks an SM (1 KB reserved a block)
        assert p.smem <= fd.ROW_SMEM_MAX and 3 * (p.smem + 1024) <= 228 * 1024
    full = -(-S // p.kps)
    assert p.splits == (full if window is None else min(full, -(-window // p.kps)))
    # the rule: with a window, the smallest split that holds it and fits a block (else the
    # largest that keeps three blocks an SM); without, the smallest of at least 32 keys a head
    # within the grid bound, else the largest
    smem = lambda k: fd.row_smem(k, d, rep, quant, fd.row_splits(S, k, window))
    fits = [k for k in fd.ROW_KPS if smem(k) <= fd.ROW_SMEM_MAX]
    if window is not None:
        good = [k for k in fd.ROW_KPS if k >= window and smem(k) <= 232448]
    else:
        good = [k for k in fits if k >= 32 * rep
                and b * hkv * fd.row_splits(S, k, window) <= fd.ROW_BLOCKS_PER_SM * SMS]
    assert p.kps == (good[0] if good else fits[-1])
    for pos in range(S):
        ranges, kstart, kend, n_act = _blocks_of_row(p.kps, p.splits, window, pos)
        assert 1 <= n_act <= p.splits
        held = [(k0, k1) for k0, k1 in ranges if k0 < k1]
        assert held == ranges[:n_act]
        assert held[0][0] == kstart and held[-1][1] == kend
        assert all(a[1] == c[0] for a, c in zip(held, held[1:]))
        assert all(0 < k1 - k0 <= p.kps for k0, k1 in held)
        if window is not None and p.kps >= window:
            assert n_act == 1  # a windowed row needs no merge


def test_k3_row_plan_is_the_issue_grid_at_the_main_path_shapes():
    """Llama-2-7B at B=4 (int8) takes 256-key splits, at B=1 and Mixtral at
    B=4 128; a 256-key window takes one split of 256 keys, int8 or bf16."""
    assert fd.row_plan(4, 32, 1, 128, 2048, True) == fd.RowPlan(256, 8, fd.row_smem(256, 128, 1, True, 8))
    assert fd.row_plan(1, 32, 1, 128, 2048, True).kps == 128
    assert fd.row_plan(4, 8, 4, 128, 2048, True).kps == 128
    assert fd.row_plan(4, 32, 1, 128, 2048, False).kps == 128  # bf16 rows: 256 keys would be 131 KB
    p8, p16 = fd.row_plan(4, 32, 1, 128, 2048, True, 256), fd.row_plan(4, 32, 1, 128, 2048, False, 256)
    assert (p8.kps, p8.splits, p16.kps, p16.splits) == (256, 1, 256, 1)
    with pytest.raises(ValueError):
        fd.row_plan(4, 1, 71, 64, 2048, True)


@pytest.mark.parametrize("d,quant", [(128, True), (128, False), (64, True), (64, False)])
def test_k3_row_kernel_score_reads_and_stores_bank_model(d, quant):
    """The score tiles' 16-byte K reads (thread tig at chunk tig + 4 i of
    rows gid and gid + 8, rows as the bulk copies land them, whole and
    unpadded) meet each bank at most once a quarter warp for 64-byte rows
    and at most twice for longer ones (two rows of 128 or 256 bytes start on
    the same bank); the scores' 4-byte stores into the warp's p buffer
    (head 2 tig + (e & 1) of key gid (+ 8): rows of 16 x tiles + 4 floats)
    meet 32 distinct banks each warp."""
    row = d * (1 if quant else 2)
    cpr = row // 16
    for mt in (0, 3):
        for i in range(cpr // 4):
            for plus8 in (0, 8):
                for phase in range(4):
                    banks = []
                    for lane in range(8 * phase, 8 * phase + 8):
                        gid, tig = lane // 4, lane % 4
                        addr = (mt * 16 + gid + plus8) * row + (tig + 4 * i) * 16
                        banks += [(addr // 4 + k) % 32 for k in range(4)]
                    assert max(banks.count(bk) for bk in range(32)) == (1 if cpr == 4 else 2)
    for kps in fd.ROW_KPS:
        pst = 16 * -(-(kps // 16) // 8) + 4
        for j in range(2):
            for e in range(4):
                banks = [((2 * (lane % 4) + (e & 1)) * pst + 16 * j + lane // 4 + 8 * (e >> 1)) % 32
                         for lane in range(32)]
                assert sorted(banks) == list(range(32))


S_SMALL, D_SMALL = 320, 64
OFFSETS = [0, 63, 64, 319]
LENGTHS = [0, 1, 200, 320]


@functools.lru_cache(maxsize=None)
def _case(kind, rep, quant, window):
    """Inputs (numpy) and JAX's output for K3 ("write", at OFFSETS) or B6
    ("attend", at LENGTHS), 2 kv heads over a 320-row cache, layer 1 of 2."""
    rng = np.random.default_rng(rep * 10 + quant * 3 + (window or 0) + (kind == "write"))
    hkv = 2
    b = len(OFFSETS)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, 1, hkv * rep, D_SMALL)), jnp.bfloat16))
    shape = (2, b, hkv, S_SMALL, D_SMALL)
    if quant:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, shape[:-1] + (1,)).astype(np.float32) for _ in range(2))
        nk, nv = (rng.integers(-127, 128, (b, 1, hkv, D_SMALL)).astype(np.int8) for _ in range(2))
        nks, nvs = (rng.uniform(0.005, 0.03, (b, 1, hkv, 1)).astype(np.float32) for _ in range(2))
    else:
        k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)) for _ in range(2))
        ks = vs = nks = nvs = None
        nk, nv = (np.asarray(jnp.asarray(rng.standard_normal((b, 1, hkv, D_SMALL)), jnp.bfloat16))
                  for _ in range(2))
    j = lambda a: None if a is None else jnp.asarray(a)
    if kind == "write":
        want = jfd.flash_decode_write_attention_indexed(
            j(q), j(nk), j(nv), j(k), j(v), j(ks), j(vs), 1, jnp.asarray(OFFSETS, jnp.int32),
            k_scale_new=j(nks), v_scale_new=j(nvs), window=window)[0]
    else:
        want = jfd.flash_decode_attention_indexed(
            j(q), j(k), j(v), j(ks), j(vs), jnp.int32(1), jnp.asarray(LENGTHS, jnp.int32),
            window=window)
    return (q, k, v, ks, vs, nk, nv, nks, nvs), f32(want).reshape(b, hkv, rep, D_SMALL)


def _torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return t(jnp.asarray(a))
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("kind,rep", [("write", r) for r in fd.ROW_REPS] + [("attend", 1), ("attend", 8)])
def test_row_plan_plain_matches_jax(kind, rep, quant, window):
    """The plain K3 (offsets 0/63/64/319) and B6 (lengths 0/1/200/320; 0
    gives the mean of V over the visited tiles) cut as the row kernel cuts
    them, in the plan's splits and in 64-key splits (2-5 of them), from each
    row's first key, equal the unsplit f32 result and JAX's interpret-mode
    kernels, and K3 writes the new rows as JAX does."""
    inputs, want = _case(kind, rep, quant, window)
    q, k, v, ks, vs, nk, nv, nks, nvs = (_torch(a) for a in inputs)
    b, hkv = k.shape[1], k.shape[2]
    q_hm = q.reshape(b, hkv, rep, D_SMALL)
    span = window if kind == "write" else fd._b6_span(S_SMALL, window)
    plan = fd.row_plan(b, hkv, rep, D_SMALL, S_SMALL, quant, span)
    assert fd.row_splits(S_SMALL, 64, span) > 1
    pick = lambda a: None if a is None else a[1]

    def run(kps):
        kc, vc = k.clone(), v.clone()
        ksc, vsc = (None, None) if ks is None else (ks.clone(), vs.clone())
        if kind == "write":
            out = fd.plain(q_hm, nk[:, 0], nv[:, 0], None if nks is None else nks[:, 0, :, 0],
                           None if nvs is None else nvs[:, 0, :, 0], kc[1], vc[1], pick(ksc),
                           pick(vsc), torch.tensor(OFFSETS, dtype=torch.int32), D_SMALL ** -0.5,
                           window, out_dtype=torch.float32, kps=kps)
        else:
            out = fd.plain_attend(q_hm, kc[1], vc[1], pick(ksc), pick(vsc),
                                  torch.tensor(LENGTHS, dtype=torch.int32), D_SMALL ** -0.5,
                                  window, out_dtype=torch.float32, kps=kps)
        return out.numpy(), kc

    one, _ = run(None)
    tol = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(want).max()
    for kps in (plan.kps, 64):
        got, kc = run(kps)
        assert np.isfinite(got).all()
        assert np.abs(got - one).max() <= 1e-5 * np.abs(one).max()
        assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())
    if kind == "write":
        for i, off in enumerate(OFFSETS):
            assert torch.equal(kc[1, i, :, off], nk[i, 0])
