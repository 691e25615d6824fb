"""B5's launch geometry on the CPU (no card needed).

``gather_prefill.dequant_wt_plan`` lays out ``csrc/gather_dequant_wt.cu``: a
unit is one input group by 256 output columns; a warp walks units
warp-strided, column chunk fastest; a lane takes one run of 8 bf16 columns
or two runs of 4 f32 columns (128 apart), one 16-byte store a row each. A
model of the kernel's index arithmetic, driven by the plan, must write every
element of W^T once at OUT 128-14336 (tile widths 128 and 512, the partly
empty warp at OUT % 256 == 128) and ragged IG; each run lies in one tile and
reads its code bytes in one aligned load; a warp's store of a row covers 512
contiguous bytes. The same model, computing values, is bit-identical to the
plain version.
"""

import numpy as np
import pytest
import torch

from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import lut_gemv as lg

SMS = 132  # an H100 SXM's
WARPS = 8  # a block's


def _lanes(p, out_f):
    """Every (unit, lane, run) the kernel's loops visit, in the order of its
    grid-stride loop: arrays (ig, column of the run's first element), and
    the warp each came from."""
    n_warps = p.blocks * WARPS
    units = np.concatenate([np.arange(w, p.units, n_warps) for w in range(n_warps)])
    warp_of = np.concatenate([np.full(len(range(w, p.units, n_warps)), w) for w in range(n_warps)])
    lane, r = np.arange(32), np.arange(p.runs)
    ig = units[:, None, None] // p.chunks
    col = (units % p.chunks)[:, None, None] * 256 + r[None, None, :] * 32 * p.run \
        + lane[None, :, None] * p.run
    ig, col = np.broadcast_to(ig, col.shape), col
    return units, warp_of, ig, col


def _tile_widths():
    for out_f in (128, 256, 384, 512, 640, 4096, 11008, 14336):
        for tn in (128, 512):
            if out_f % tn == 0:
                yield out_f, tn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("ig_count", [1, 37, 512])
@pytest.mark.parametrize("out_f,tn", list(_tile_widths()))
def test_dequant_wt_plan_covers_every_element_once(out_f, tn, ig_count, dtype):
    p = gp.dequant_wt_plan(out_f, ig_count, dtype, SMS)
    assert p.run == (8 if dtype == torch.bfloat16 else 4) and p.runs * p.run == 8
    assert p.chunks == -(-out_f // 256) and p.units == p.chunks * ig_count
    assert 1 <= p.blocks <= 2 * SMS and (p.blocks - 1) * WARPS < p.units  # no empty block
    units, _, ig, col = _lanes(p, out_f)
    assert np.array_equal(np.sort(units), np.arange(p.units))  # each unit once
    valid = col < out_f
    # only the last chunk's upper half is empty, and only at OUT % 256 == 128
    assert valid.all() == (out_f % 256 == 0)
    assert (col[~valid] >= out_f).all() and (col[~valid] < p.chunks * 256).all()
    # each run of a lane: its columns in one tile, its code bytes one aligned load
    c = col % tn
    assert (c % p.run == 0).all() and (c + p.run <= tn).all()
    K = 2
    code_addr = (col // tn) * K * ig_count * tn + ig * K * tn + c  # codebook k adds k * tn
    assert (code_addr % p.run == 0).all()
    # every (row group, run) of W^T once; the 8 rows of a group go with it
    hits = np.zeros((ig_count, out_f // p.run), dtype=np.int64)
    np.add.at(hits, (ig[valid], col[valid] // p.run), 1)
    assert (hits == 1).all()
    # a warp's store of a row: 32 lanes x 16 bytes, contiguous, for each run
    first = col[:, 0, :]
    assert (col - first[:, None, :] == np.arange(32)[None, :, None] * p.run).all()


@pytest.mark.parametrize("name,out_f,in_f", [("q", 4096, 4096), ("gate", 11008, 4096),
                                             ("down", 4096, 11008), ("fc1", 18176, 4544)])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_dequant_wt_plan_at_main_path_shapes(name, out_f, in_f, sms):
    """Two full blocks an SM at every full-width projection: q's 8192 units
    are ~3.9 a warp on 132 SMs, gate's 22016 ~10.4."""
    for dtype in (torch.bfloat16, torch.float32):
        p = gp.dequant_wt_plan(out_f, in_f // 8, dtype, sms)
        assert p.blocks == 2 * sms
        assert p.units == -(-out_f // 256) * (in_f // 8)


def test_dequant_wt_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bf16 or f32"):
        gp.dequant_wt_plan(128, 1, torch.float16)


def _model(codes_tl, cb, scales, dtype, sms):
    """W^T as the kernel computes it, lane by lane from the plan: each run's
    code bytes read as one little-endian word, each byte's entry gathered,
    the entries summed in f32 from k = 0, times the scale, rounded once."""
    nt, kig, tn = codes_tl.shape
    K = cb.shape[0]
    ig_count, out_f = kig // K, nt * tn
    p = gp.dequant_wt_plan(out_f, ig_count, dtype, sms)
    _, _, ig, col = _lanes(p, out_f)
    valid = col < out_f
    ig, col = torch.from_numpy(ig[valid]), torch.from_numpy(col[valid])
    flat = codes_tl.reshape(-1)
    cbf = cb.float()
    base = (col // tn) * kig * tn + ig * K * tn + col % tn
    out = torch.full((ig_count * 8, out_f), float("nan"), dtype=dtype)
    for i in range(p.run):  # column i of each run: byte i of its code word
        acc = None
        for k in range(K):
            word = sum(flat[base + k * tn + b].long() << (8 * b) for b in range(p.run))
            entry = cbf[k, (word >> (8 * i)) & 0xFF]  # [n, 8]: rows ig*8 + j
            acc = entry if acc is None else acc + entry
        v = (acc * scales[col + i][:, None]).to(dtype)
        for j in range(8):
            out[ig * 8 + j, col + i] = v[:, j]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K,out_f,ig_count", [(1, 128, 3), (2, 384, 5), (3, 640, 2), (8, 512, 1),
                                              (2, 1024, 4)])
def test_dequant_wt_model_is_bit_identical_to_plain(K, out_f, ig_count, dtype):
    rng = np.random.default_rng(K * out_f + ig_count)
    codes_t = torch.from_numpy(rng.integers(0, 256, (K, ig_count, out_f), dtype=np.uint8))
    codes_tl = lg.tile_codes(codes_t)
    cb = torch.from_numpy(rng.standard_normal((K, 256, 8), dtype=np.float32) / 4).to(torch.bfloat16)
    scales = torch.from_numpy(rng.random(out_f, dtype=np.float32) + 0.5)
    want = gp.dequant_wt_plain(codes_tl, cb, scales, dtype)
    assert torch.equal(_model(codes_tl, cb, scales, dtype, sms=3), want)
