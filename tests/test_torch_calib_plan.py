"""B13's and B14's launch geometry on the CPU (no card needed).

- ``kernels.cb_grad_plan``: B14's blocks (one an SM at most, none empty),
  its float2 lanes (even g, aligned data), thread rows, bank-interleaved copies (each of a warp's adds on 32
  distinct banks whatever the codes, the aliasing copies' column pairs
  swapped), shared memory within ``SMEM_LIMIT`` and the partial sums, at
  Llama-2-7B's, Mixtral-8x7B's and Falcon-7B's calibration shapes and at
  the edges (G 0 and 1, g above a block's threads, K 1-8, S up to 512).
- A model of B14's loops: every element of the data once.
- A model of B13's index arithmetic: the multiply-and-shift division the
  kernel uses for a lane's group and row (exact for every index below 2^31
  at the divisors it meets), its lanes at g % 4 == 0 (each float4 of W
  once, a warp's store 512 contiguous bytes) and its runs of whole rows
  below 2^31 floats.
"""

import numpy as np
import pytest

from aqlm_tpu_torch.ops import kernels as kn

SMS = 132  # an H100 SXM's

# (name, out_features, in_features): projections calibration dequantizes
CALIB_SHAPES = [("llama_q", 4096, 4096), ("llama_gate", 11008, 4096), ("llama_down", 4096, 11008),
                ("mixtral_w1", 14336, 4096), ("mixtral_w2", 4096, 14336),
                ("falcon_qkv", 4672, 4544), ("falcon_fc2", 4544, 18176)]


def _check_plan(p, G, K, S, g, sms, pairs=True):
    assert 1 <= p.blocks <= min(sms, 256)  # the merge kernel takes 16 chunks of 16 slices
    assert p.vec == (2 if pairs and g % 2 == 0 else 1)
    assert p.cols == min(g // p.vec, 1024) and p.rows == 1024 // p.cols >= 1
    assert p.smem == K * S * g * p.slots * 4 <= kn.SMEM_LIMIT
    interleave = 32 % p.cols == 0 and K * S * 32 * p.vec * 4 <= kn.SMEM_LIMIT
    assert p.slots == (32 // p.cols if interleave else 1)
    if p.slots > 1:  # a warp's group rows on copies of their own: its lanes on distinct banks
        rng = np.random.default_rng(K * S + g)
        for _ in range(20):  # any codes of the warp's group rows, any codebook
            k, codes = rng.integers(0, K), rng.integers(0, S, p.slots)
            lanes = np.arange(32)
            row, col = lanes // p.cols, lanes % p.cols
            # each of a lane's vec adds (one float each), the aliasing copies'
            # column pairs swapped (j ^ 1) at vec 2
            sw = (row * g) >> 5 if p.vec == 2 else 0
            for e in range(p.vec):
                word = ((k * S + codes[row]) * p.slots + row) * g + ((p.vec * col + e) ^ sw)
                assert len(set(word % 32)) == 32
    assert p.groups_per_block == -(-G // p.blocks)  # as the kernel computes it
    if G:  # no empty block
        assert (p.blocks - 1) * p.groups_per_block < G
    assert p.partials == p.blocks * K * S * g


@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("name,out_f,in_f", CALIB_SHAPES, ids=lambda v: str(v))
def test_cb_grad_plan_at_calibration_shapes(name, out_f, in_f, K):
    """One block an SM at every full-width projection, each writing one
    [K, S, g] partial (2.1 MB in all at 2x8); a float2 a thread, eight
    bank-interleaved copies where they fit (K 1-2)."""
    G, S, g = out_f * in_f // 8, 256, 8
    p = kn.cb_grad_plan(G, K, S, g, SMS)
    _check_plan(p, G, K, S, g, SMS)
    assert p.blocks == SMS
    assert p.vec == 2 and p.slots == (8 if K <= 2 else 1)


@pytest.mark.parametrize("G", [0, 1, 1001, 4095, 4096, 4097, 30001, 77777, 540673, 10 ** 7])
@pytest.mark.parametrize("K,S,g", [(1, 16, 8), (2, 256, 8), (8, 256, 8), (2, 512, 8), (3, 16, 4),
                                   (5, 64, 3), (4, 256, 16), (2, 256, 32), (1, 64, 32),
                                   (3, 64, 1), (2, 256, 2), (1, 1, 3000)])
@pytest.mark.parametrize("pairs", [True, False])
def test_cb_grad_plan_edges(G, K, S, g, pairs):
    p = kn.cb_grad_plan(G, K, S, g, SMS, pairs)
    _check_plan(p, G, K, S, g, SMS, pairs)
    # one an SM, at most one a group (fewer where runs of whole groups fill fewer)
    assert p.blocks <= max(1, min(SMS, G))


@pytest.mark.parametrize("sms", [1, 16, 17, 114, 132, 300])
def test_cb_grad_plan_other_cards(sms):
    G, K, S, g = 5_636_096, 2, 256, 8
    p = kn.cb_grad_plan(G, K, S, g, sms)
    _check_plan(p, G, K, S, g, sms)
    assert p.blocks == min(sms, 256)


@pytest.mark.parametrize("pairs", [True, False])
@pytest.mark.parametrize("G,g", [(0, 8), (1, 8), (1001, 8), (4099, 8), (513, 4), (2000, 3),
                                 (3, 1500), (3, 3000), (77777, 16), (20000, 2)])
def test_cb_grad_thread_mapping_takes_every_element_once(G, g, pairs):
    """The kernel's loops, run as index arithmetic: block b's groups
    [b * per_block, min(G, (b + 1) * per_block)), thread t's columns
    vec * (t % cols) (+ vec * cols, ...) of groups t // cols + i * rows."""
    p = kn.cb_grad_plan(G, 2, 16, g, SMS, pairs)
    seen = np.zeros((G, g), dtype=np.int64)
    for b in range(p.blocks):
        g0, g1 = b * p.groups_per_block, min(G, (b + 1) * p.groups_per_block)
        for t in range(kn.CB_GRAD_THREADS):
            tr, tj = divmod(t, p.cols)
            if tr >= p.rows:
                continue
            for j in range(p.vec * tj, g, p.vec * p.cols):
                seen[g0 + tr:g1:p.rows, j:j + p.vec] += 1
    assert (seen == 1).all()


def _fast_div(d):
    """The kernel's FastDiv: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1."""
    l = 0
    while (1 << l) < d:
        l += 1
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


def _div_by(n, m, l):
    """(mulhi(n, m) + n) >> l in uint32 arithmetic (n < 2^31)."""
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    s = t + n
    assert (s < np.uint64(1 << 32)).all()  # no 32-bit overflow
    return s >> np.uint64(l)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 12, 375, 512, 513, 568, 1376, 1792, 2272,
                               4096, 65535, 2 ** 20 + 1, 2 ** 31 - 1])
def test_b13_division_is_exact(d):
    """Group (f / (g/4), f / g) and row (n / IG) by a multiply and a shift:
    exact at the divisors the kernel meets (g/4, g, IG at Llama, Mixtral,
    Falcon widths), over the edges of the 32-bit range and random indices."""
    m, l = _fast_div(d)
    assert 0 < m < 1 << 32
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(0, 5000), 2 ** 31 - 1 - np.arange(0, 5000),
                        rng.integers(0, 2 ** 31, 200000), np.arange(1, 64) * d - 1,
                        np.arange(1, 64) * d])
    n = n[(n >= 0) & (n < 2 ** 31)]
    assert (_div_by(n, m, l) == n // d).all()


@pytest.mark.parametrize("g", [4, 8, 16])
def test_b13_lanes_cover_w_in_whole_warp_stores(g):
    """At g % 4 == 0 lane l of a step's warp w owns float4 f = base + u * 256
    + 32 w + l: W's float4s once each, a warp's 32 in one 512-byte run, its
    lanes' groups f / (g/4) in order."""
    og, ig = 37, 11
    n4 = og * ig * g // 4
    threads, units, grid = 256, 4, 3
    seen = np.zeros(n4, dtype=np.int64)
    step = grid * threads * units
    for b in range(grid):
        for f0 in range(b * threads * units, n4, step):
            for u in range(units):
                for w in range(threads // 32):
                    f = f0 + u * threads + 32 * w + np.arange(32)
                    f = f[f < n4]
                    assert (np.diff(f * 16) == 16).all()  # contiguous 16-byte stores
                    seen[f] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("ig,g", [(512, 8), (1376, 8), (1792, 8), (568, 8), (1, 8), (3, 5)])
def test_b13_runs_of_whole_rows_stay_below_2g_floats(ig, g):
    """A launch is cut into runs of whole rows, each under 2^31 floats."""
    rows_per_run = (2 ** 31 - 1) // (ig * g)
    assert rows_per_run * ig * g <= 2 ** 31 - 1
    assert (rows_per_run + 1) * ig * g > 2 ** 31 - 1
