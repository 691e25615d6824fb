"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the kernels have
no CPU mode). Run them on a machine with the card (``--noconftest``: the
suite's conftest imports JAX, which the port does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance on bf16 outputs: one bf16 step of the plain result plus 1e-3 of its
largest magnitude (both round an f32 sum taken in another order); two steps
for B15 (``onehot_matmul``), which rounds twice, the product and then the
scaled product, as the TPU kernel does. K2's f32 instance, the prefill route
of the all-expert codes matmul, is held against K2's plain version with an
f32 output (the weight rounded to bf16, as K2 rounds it), within one step."""

import dataclasses
import functools
import math
import re

import numpy as np
import pytest
import torch

from aqlm_tpu_torch.config import SCHEME_1X16, SCHEME_2X8
from aqlm_tpu_torch.models import llama, mixtral
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import gather16 as g16
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops import kernels as k15
from aqlm_tpu_torch.ops import kv_write as kw
from aqlm_tpu_torch.ops import lut_gemv as lg
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

CODES_KERNELS = ("lut_gemv", "gather_prefill", "flash_decode_write")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, steps=1):
    g, w = got.float(), want.float()
    tol = steps * 2.0 ** -7 * w.abs() + 1e-3 * w.abs().max()
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


def _codes(gen, dev, sizes, in_f):
    tn = min(lg.lut_tile_n(s) for s in sizes)
    nt, kig = sum(sizes) // tn, in_f // 8 * 2
    codes = torch.randint(0, 256, (2, nt, kig, tn), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((2, len(sizes), 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand((2, sum(sizes)), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("sizes", [(512,), (256, 128, 128)])
def test_lut_gemv_kernel_matches_plain(dev, sizes, rows):
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _codes(gen, dev, sizes, 256)
    x = torch.randn((rows, 256), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["lut_gemv"].launches
    got = lg.lut_gemv_kx8_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    assert _build.KERNELS["lut_gemv"].launches == before + 1
    pm = lg.proj_map_for(sizes, codes.shape[-1], dev)
    _close(got, lg.plain(x, codes[1], cb[1], scales[1], pm, torch.bfloat16))


@pytest.mark.parametrize("sizes", [(512,), (128, 256)])
def test_gather_prefill_kernel_matches_plain(dev, sizes):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _codes(gen, dev, sizes, 256)
    x = torch.randn((77, 256), generator=gen, device=dev).to(torch.bfloat16)  # a ragged token tile
    got = gp.gather_prefill_matmul_grouped_indexed(x, codes, cb, scales, sizes, 0, group=8)
    pm = lg.proj_map_for(sizes, codes.shape[-1], dev)
    _close(got, gp.plain(x, codes[0], cb[0], scales[0], pm))


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("quantized", [True, False])
def test_flash_decode_kernel_matches_plain(dev, quantized, window):
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, HQ, H, S, D = 2, 3, 8, 2, 256, 64
    offsets = torch.tensor([0, 63, 200], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, HQ, D), generator=gen, device=dev)
    if quantized:
        kv = [torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8) for _ in range(2)]
        sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        new = [torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8) for _ in range(2)]
        nsc = [torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50 for _ in range(2)]
    else:
        kv = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2)]
        sc = nsc = [None, None]
        new = [torch.randn((B, 1, H, D), generator=gen, device=dev) for _ in range(2)]
    ref = [[None if t is None else t.clone() for t in pair] for pair in (kv, sc)]
    got = fd.flash_decode_write_attention_indexed(q, new[0], new[1], kv[0], kv[1], sc[0], sc[1], 1,
                                                  offsets, k_scale_new=nsc[0], v_scale_new=nsc[1],
                                                  window=window)
    ref_dev = [[None if t is None else t.to("cpu") for t in pair] for pair in ref]
    want = fd.flash_decode_write_attention_indexed(
        q.cpu(), new[0].cpu(), new[1].cpu(), ref_dev[0][0], ref_dev[0][1], ref_dev[1][0],
        ref_dev[1][1], 1, offsets.cpu(),
        k_scale_new=None if nsc[0] is None else nsc[0].cpu(),
        v_scale_new=None if nsc[1] is None else nsc[1].cpu(), window=window)
    _close(got[0].cpu(), want[0])
    assert torch.equal(kv[0].cpu(), ref_dev[0][0]) and torch.equal(kv[1].cpu(), ref_dev[0][1])


def test_flash_decode_kernel_out_of_range_offset_writes_nothing(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, H, S, D = 1, 2, 2, 128, 64
    offsets = torch.tensor([5, S], dtype=torch.int32, device=dev)  # row 1 lies past the cache
    q = torch.randn((B, 1, H, D), generator=gen, device=dev)
    kv = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    new = [torch.randn((B, 1, H, D), generator=gen, device=dev) for _ in range(2)]
    before = [t.clone() for t in kv]
    out = fd.flash_decode_write_attention_indexed(q, new[0], new[1], kv[0], kv[1], None, None, 0,
                                                  offsets)[0]
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1].float()).all())
    for t, t0 in zip(kv, before):
        assert torch.equal(t[:, 1], t0[:, 1])


def test_engine_on_the_card_launches_every_kernel(dev):
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=256,
                                 num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8)
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True))
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    assert all(_build.KERNELS[k].launches > 0 for k in CODES_KERNELS)
    assert _build.KERNELS["int8_matmul"].launches == _build.KERNELS["int4_matmul"].launches == 0
    assert _build.KERNELS["int8_moe_matmul"].launches == _build.KERNELS["int4_moe_matmul"].launches == 0


def _int8(gen, dev, L, out_f=520, in_f=11008):
    """Stacked int8 weights [L, OUT, IN_pad] with aqlm_tpu's padding (11008 ->
    11264, zero columns), scales, bias; OUT=520 leaves ragged row tiles."""
    w8 = torch.randint(-127, 128, (L, out_f, im.pad_in_features(in_f)), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    w8[..., in_f:] = 0
    scale = torch.rand((L, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
    bias = torch.randn((L, out_f), generator=gen, device=dev)
    return w8, scale, bias


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 200])
def test_int8_matmul_kernel_matches_plain(dev, rows):
    gen = torch.Generator(device=dev).manual_seed(rows)
    w8, scale, bias = _int8(gen, dev, 3)
    x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int8_matmul"].launches
    got = im.int8_matmul_indexed(x, w8, scale, 1, bias)
    assert _build.KERNELS["int8_matmul"].launches == before + 1
    want = im.plain(x, w8[1], scale[1]) + bias[1].to(torch.bfloat16)
    _close(got, want)


def test_int8_matmul_kernel_is_deterministic(dev):
    """The split-contraction reduction adds the splits in a fixed order."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, scale, _ = _int8(gen, dev, 1, out_f=4096)
    for rows in (4, 64):
        x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
        assert torch.equal(im.int8_matmul(x, w8[0], scale[0]), im.int8_matmul(x, w8[0], scale[0]))


def test_int8_matmul_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, scale, _ = _int8(gen, dev, 1, out_f=256, in_f=1024)
    x = torch.randn((4, 1024), generator=gen, device=dev)
    with pytest.raises(ValueError, match="bf16"):  # f32 activations stay a CPU-plain limit
        im.int8_matmul(x, w8[0], scale[0])
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        im.launch(xb, w8[0].t().contiguous().t(), scale[0])
    with pytest.raises(ValueError, match="int8 weights"):
        im.int8_matmul(xb, w8[0].to(torch.int16), scale[0])
    with pytest.raises(ValueError, match="f32 scales"):
        im.int8_matmul(xb, w8[0], scale[0].to(torch.bfloat16))


# (OUT, IN): a ragged OUT over IN 11008 in ld 11264, Falcon-7B's q and k
# (OUT 64), Llama-2-7B's fused gate/up; with GEMM_ROWS they take every
# branch of the prefill plans (BM 64/128/256 for int8, 64/128 for int4,
# split and unsplit)
GEMM_SHAPES = [(520, 11008), (4544, 4544), (64, 4544), (22016, 4096)]
GEMM_ROWS = [9, 63, 64, 65, 200, 256, 257, 1024]


def test_gemm_cases_cover_every_plan_branch(dev):
    sms = _build.sm_count(dev.index)
    int8 = {(p.bm, p.splits > 1) for p in (im.plan(r, o, i, im.pad_in_features(i), 1, sms)
                                           for o, i in GEMM_SHAPES for r in GEMM_ROWS)}
    assert int8 == {(bm, split) for bm in (64, 128, 256) for split in (False, True)}
    int4 = {(p.bm, p.splits > 1) for p in (i4.plan(r, o, i, i4.pad_in_features_int4(i) // 2, 1, sms)
                                           for o, i in GEMM_SHAPES for r in GEMM_ROWS)}
    assert int4 == {(bm, split) for bm in (64, 128) for split in (False, True)}


@pytest.mark.parametrize("rows", GEMM_ROWS)
@pytest.mark.parametrize("out_f,in_f", GEMM_SHAPES)
def test_int8_gemm_matches_plain(dev, out_f, in_f, rows):
    gen = torch.Generator(device=dev).manual_seed(rows + out_f)
    w8, scale, _ = _int8(gen, dev, 1, out_f=out_f, in_f=in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int8_matmul"].launches
    got = im.int8_matmul(x, w8[0], scale[0])
    assert _build.KERNELS["int8_matmul"].launches == before + 1
    _close(got, im.plain(x, w8[0], scale[0]))


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [65, 257, 1024])
def test_int8_moe_gemm_matches_plain(dev, rows, per_expert):
    gen = torch.Generator(device=dev).manual_seed(rows)
    w8, scale = _moe(gen, dev, 8, 520, 1040, L=1)
    x = torch.randn((8, rows, 1040) if per_expert else (rows, 1040), generator=gen,
                    device=dev).to(torch.bfloat16)
    _close(im.int8_moe_matmul(x, w8[0], scale[0]), im.moe_plain(x, w8[0], scale[0]))


@pytest.mark.parametrize("rows", [64, 257, 1024])
def test_int8_gemm_second_run_is_bit_identical(dev, rows):
    """T=64 splits the contraction (the fixed-order last-block reduction);
    every run of the same inputs gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    w8, scale, _ = _int8(gen, dev, 1, out_f=4096)
    x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
    a = im.int8_matmul(x, w8[0], scale[0])
    assert torch.equal(a, im.int8_matmul(x, w8[0], scale[0]))


def test_int8_engine_on_the_card_launches_its_kernels(dev):
    """int8 layers and head run on the int8 kernel; decode attention on K3
    (max_len >= 1024 takes the flash rule for int8 layers)."""
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=256,
                                 num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     mode="int8")
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=1024, prefill_buckets=(16, 32),
                                             kv_quantized=True, lm_head_int8=True))
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    assert launches["int8_matmul"] > 0 and launches["flash_decode_write"] > 0
    assert launches["lut_gemv"] == launches["gather_prefill"] == launches["int4_matmul"] == 0
    assert launches["int8_moe_matmul"] == launches["int4_moe_matmul"] == 0


def _moe(gen, dev, E, out_f, in_f, L=2):
    """Stacked all-expert int8 weights [L, E, OUT, IN_pad] (zero padding
    columns) and scales [L, E, OUT]."""
    w8 = torch.randint(-127, 128, (L, E, out_f, im.pad_in_features(in_f)), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int8)
    w8[..., in_f:] = 0
    scale = torch.rand((L, E, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
    return w8, scale


# (E, OUT, IN): split-K at E=2, OUT=128 (few blocks); a ragged OUT with a
# padded IN (1040 -> 2048); Mixtral-8x7B's gate/up and down
MOE_SHAPES = [(2, 128, 4096), (3, 520, 1040), (8, 14336, 4096), (8, 4096, 14336)]


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 200])
@pytest.mark.parametrize("shape", MOE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_moe_matmul_kernel_matches_plain(dev, shape, rows, per_expert):
    E, out_f, in_f = shape
    gen = torch.Generator(device=dev).manual_seed(rows)
    w8, scale = _moe(gen, dev, E, out_f, in_f)
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen,
                    device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int8_moe_matmul"].launches
    got = im.int8_moe_matmul_indexed(x, w8, scale, 1)
    assert _build.KERNELS["int8_moe_matmul"].launches == before + 1
    assert got.shape == (E, rows, out_f)
    _close(got, im.moe_plain(x, w8[1], scale[1]))


def test_int8_moe_matmul_kernel_is_deterministic(dev):
    """Split-K at E=2, OUT=128: each expert's splits are added in a fixed
    order by its own last block."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, scale = _moe(gen, dev, 2, 128, 4096, L=1)
    for rows in (4, 64):
        x = torch.randn((2, rows, 4096), generator=gen, device=dev).to(torch.bfloat16)
        a = im.int8_moe_matmul(x, w8[0], scale[0])
        assert torch.equal(a, im.int8_moe_matmul(x, w8[0], scale[0]))
        # each expert agrees with the dense form run on it alone
        for e in range(2):
            _close(a[e], im.int8_matmul(x[e], w8[0, e], scale[0, e]))


def test_int8_moe_matmul_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, scale = _moe(gen, dev, 2, 256, 1024, L=1)
    x = torch.randn((4, 1024), generator=gen, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        im.int8_moe_matmul(x, w8[0], scale[0])
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="per-expert x"):
        im.int8_moe_matmul(torch.stack([xb] * 3), w8[0], scale[0])
    with pytest.raises(ValueError, match="does not match"):
        im.int8_moe_matmul(xb, w8[0], scale[0, :, :128].contiguous())
    with pytest.raises(ValueError, match="int8 weights"):
        im.int8_moe_matmul(xb, w8[0].to(torch.int16), scale[0])


def test_mixtral_int8_engine_on_the_card_launches_its_kernels(dev):
    """Experts run only through the all-expert kernel, 3 launches per layer
    per forward; the int8 kernel's count is the fused qkv, o and the head."""
    cfg = mixtral.MixtralConfig.tiny_moe(num_layers=2, hidden_size=256, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     mode="int8")
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=1024, prefill_buckets=(16, 32),
                                             kv_quantized=True, lm_head_int8=True,
                                             donate_params=True))
    assert isinstance(engine.params["layers"]["experts_gate_proj"], mixtral.StackedInt8Experts)
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    L = cfg.num_layers
    forwards = launches["int8_matmul"] // (2 * L + 1)
    assert forwards > 0 and launches["int8_matmul"] == forwards * (2 * L + 1)
    assert launches["int8_moe_matmul"] == forwards * 3 * L
    assert launches["flash_decode_write"] > 0
    assert launches["lut_gemv"] == launches["gather_prefill"] == launches["int4_matmul"] == 0
    assert launches["int4_moe_matmul"] == 0


def _int4(gen, dev, L, out_f=520, in_f=11008):
    """Stacked int4 weights [L, OUT, IN_pad/2] quantized from random dense
    ones (11008 -> 11264 with aqlm_tpu's padding; 1152 -> 2048, a partial
    256-column block), group scales [L, IN_pad/128, OUT], bias."""
    packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev) * in_f ** -0.5)
             for _ in range(L)]
    w4 = torch.stack([p[0] for p in packs])
    gs = torch.stack([p[1] for p in packs])
    bias = torch.randn((L, out_f), generator=gen, device=dev)
    return w4, gs, bias


@pytest.mark.parametrize("in_f", [11008, 1152])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 200])
def test_int4_matmul_kernel_matches_plain(dev, rows, in_f):
    gen = torch.Generator(device=dev).manual_seed(rows)
    w4, gs, bias = _int4(gen, dev, 3, in_f=in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int4_matmul"].launches
    got = i4.int4_matmul_indexed(x, w4, gs, 1, bias)
    assert _build.KERNELS["int4_matmul"].launches == before + 1
    want = i4.plain(x, w4[1], gs[1]) + bias[1].to(torch.bfloat16)
    _close(got, want)


@pytest.mark.parametrize("rows", [1, 16])
def test_int4_matmul_kernel_nibble_order(dev, rows):
    """x = e_c gives column c of the dequantized weight, for columns in both
    nibbles of several packing blocks."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w4, gs, _ = _int4(gen, dev, 1, out_f=256, in_f=768)
    oracle = i4.dequantize_int4(w4[0], gs[0]).to(torch.bfloat16)
    for col in (0, 5, 127, 128, 200, 255, 256, 383, 384, 511, 640, 767):
        x = torch.zeros((rows, 768), dtype=torch.bfloat16, device=dev)
        x[:, col] = 1
        assert torch.equal(i4.int4_matmul(x, w4[0], gs[0])[0], oracle[:, col]), col


def test_int4_matmul_kernel_is_deterministic(dev):
    """The split-contraction reduction adds the splits in a fixed order."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w4, gs, _ = _int4(gen, dev, 1, out_f=4096)
    for rows in (4, 64):
        x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
        assert torch.equal(i4.int4_matmul(x, w4[0], gs[0]), i4.int4_matmul(x, w4[0], gs[0]))


def test_int4_matmul_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w4, gs, _ = _int4(gen, dev, 1, out_f=256, in_f=1024)
    x = torch.randn((4, 1024), generator=gen, device=dev)
    with pytest.raises(ValueError, match="bf16"):  # f32 activations stay a CPU-plain limit
        i4.int4_matmul(x, w4[0], gs[0])
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        i4.launch(xb, w4[0].t().contiguous().t(), gs[0])
    with pytest.raises(ValueError, match="uint8 packed weights"):
        i4.int4_matmul(xb, w4[0].to(torch.int8), gs[0])
    with pytest.raises(ValueError, match="f32 group scales"):
        i4.int4_matmul(xb, w4[0], gs[0].to(torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        i4.int4_matmul(xb, w4[0], gs[0].t().contiguous())


@pytest.mark.parametrize("rows", GEMM_ROWS)
@pytest.mark.parametrize("out_f,in_f", GEMM_SHAPES)
def test_int4_gemm_matches_plain(dev, out_f, in_f, rows):
    gen = torch.Generator(device=dev).manual_seed(rows + out_f)
    w4, gs, _ = _int4(gen, dev, 1, out_f=out_f, in_f=in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int4_matmul"].launches
    got = i4.int4_matmul(x, w4[0], gs[0])
    assert _build.KERNELS["int4_matmul"].launches == before + 1
    _close(got, i4.plain(x, w4[0], gs[0]))


@pytest.mark.parametrize("rows", [64, 257, 1024])
def test_int4_gemm_second_run_is_bit_identical(dev, rows):
    gen = torch.Generator(device=dev).manual_seed(rows)
    w4, gs, _ = _int4(gen, dev, 1, out_f=4096)
    x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
    assert torch.equal(i4.int4_matmul(x, w4[0], gs[0]), i4.int4_matmul(x, w4[0], gs[0]))


def test_int4_engine_on_the_card_launches_its_kernels(dev):
    """int4 layers run on the int4 kernel, the head is a dense product;
    decode attention on K3 (max_len >= 1024 takes the flash rule)."""
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=256,
                                 num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     mode="int4")
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=1024, prefill_buckets=(16, 32),
                                             kv_quantized=True))
    assert engine.params["layers"]["qkv_proj"].mode == "int4"
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    assert launches["int4_matmul"] > 0 and launches["flash_decode_write"] > 0
    assert launches["lut_gemv"] == launches["gather_prefill"] == launches["int8_matmul"] == 0
    assert launches["int8_moe_matmul"] == launches["int4_moe_matmul"] == 0


@functools.cache
def _int4_moe(E, out_f, in_f, L=2):
    """Stacked all-expert int4 weights [L, E, OUT, IN_pad/2] quantized from
    random dense ones (1040 -> 2048: a padded IN) and group scales [L, E,
    IN_pad/128, OUT], made once per shape on the card."""
    gen = torch.Generator(device="cuda").manual_seed(E + out_f + in_f)
    packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=gen, device="cuda") * in_f ** -0.5)
             for _ in range(L * E)]
    w4 = torch.stack([p[0] for p in packs]).reshape(L, E, out_f, -1)
    gs = torch.stack([p[1] for p in packs]).reshape(L, E, -1, out_f)
    return w4, gs


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 200])
@pytest.mark.parametrize("shape", MOE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int4_moe_matmul_kernel_matches_plain(dev, shape, rows, per_expert):
    E, out_f, in_f = shape
    w4, gs = _int4_moe(E, out_f, in_f)
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen,
                    device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int4_moe_matmul"].launches
    got = i4.int4_moe_matmul_indexed(x, w4, gs, 1)
    assert _build.KERNELS["int4_moe_matmul"].launches == before + 1
    assert got.shape == (E, rows, out_f)
    _close(got, i4.moe_plain(x, w4[1], gs[1]))


@pytest.mark.parametrize("rows", [1, 16])
def test_int4_moe_matmul_kernel_nibble_order(dev, rows):
    """Per-expert one-hot x: expert e reads its own column c of its own
    dequantized weight, exactly, for columns in both nibbles of several
    packing blocks (and a shared one-hot x reads the same column of each)."""
    w4, gs = _int4_moe(3, 520, 1040)
    oracle = [i4.dequantize_int4(w4[1, e], gs[1, e]).to(torch.bfloat16) for e in range(3)]
    for cols in ((0, 128, 255), (127, 256, 383), (511, 512, 1039), (200, 200, 200)):
        x = torch.zeros((3, rows, 1040), dtype=torch.bfloat16, device=dev)
        for e, c in enumerate(cols):
            x[e, :, c] = 1
        got = i4.int4_moe_matmul_indexed(x, w4, gs, 1)
        for e, c in enumerate(cols):
            assert torch.equal(got[e, 0], oracle[e][:, c]), (e, c)
    shared = i4.int4_moe_matmul_indexed(x[0], w4, gs, 1)
    for e in range(3):
        assert torch.equal(shared[e, -1], oracle[e][:, 200])


def test_int4_moe_matmul_kernel_is_deterministic(dev):
    """Split-K at E=2, OUT=128: each expert's splits are added in a fixed
    order by its own last block."""
    w4, gs = _int4_moe(2, 128, 4096)
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in (4, 64):
        x = torch.randn((2, rows, 4096), generator=gen, device=dev).to(torch.bfloat16)
        a = i4.int4_moe_matmul(x, w4[0], gs[0])
        assert torch.equal(a, i4.int4_moe_matmul(x, w4[0], gs[0]))
        # each expert agrees with the dense form run on it alone
        for e in range(2):
            _close(a[e], i4.int4_matmul(x[e], w4[0, e], gs[0, e]))


def test_int4_moe_matmul_wrapper_raises(dev):
    w4, gs = _int4_moe(2, 128, 4096)
    w4, gs = w4[0], gs[0]
    x = torch.randn((4, 4096), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        i4.int4_moe_matmul(x, w4, gs)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="per-expert x"):
        i4.int4_moe_matmul(torch.stack([xb] * 3), w4, gs)
    with pytest.raises(ValueError, match="does not match"):
        i4.int4_moe_matmul(xb, w4, gs[:, :16].contiguous())
    with pytest.raises(ValueError, match="uint8 packed weights"):
        i4.int4_moe_matmul(xb, w4.to(torch.int8), gs)
    with pytest.raises(ValueError, match="contiguous"):
        i4.moe_launch(xb, w4, gs.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="takes w4"):
        i4.moe_launch(xb, w4[0], gs[0])


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [65, 257, 1024])
def test_int4_moe_gemm_matches_plain(dev, rows, per_expert):
    w4, gs = _int4_moe(8, 520, 1040, L=1)
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((8, rows, 1040) if per_expert else (rows, 1040), generator=gen,
                    device=dev).to(torch.bfloat16)
    _close(i4.int4_moe_matmul(x, w4[0], gs[0]), i4.moe_plain(x, w4[0], gs[0]))


def test_mixtral_int4_engine_on_the_card_launches_its_kernels(dev):
    """Experts run only through the all-expert int4 kernel, 3 launches per
    layer per forward; the int4 kernel's count is the fused qkv and o (the
    head is dense); no int8 kernel runs."""
    cfg = mixtral.MixtralConfig.tiny_moe(num_layers=2, hidden_size=256, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     mode="int4")
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=1024, prefill_buckets=(16, 32),
                                             kv_quantized=True, donate_params=True))
    assert isinstance(engine.params["layers"]["experts_gate_proj"], mixtral.StackedInt4Experts)
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    L = cfg.num_layers
    forwards = launches["int4_matmul"] // (2 * L)
    assert forwards > 0 and launches["int4_matmul"] == forwards * 2 * L
    assert launches["int4_moe_matmul"] == forwards * 3 * L
    assert launches["flash_decode_write"] > 0
    assert launches["int8_matmul"] == launches["int8_moe_matmul"] == 0
    assert launches["lut_gemv"] == launches["gather_prefill"] == 0


# --------------------------------------------------------------------------- B15 and Falcon


def _onehot(gen, dev, out_f, in_f, L=2):
    """Stacked untiled 2x8 codes [L, K, IG, OUT], codebooks, scales."""
    codes = torch.randint(0, 256, (L, 2, in_f // 8, out_f), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((L, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 77, 200])
@pytest.mark.parametrize("out_f,in_f", [(64, 4544), (200, 200), (4544, 1024), (37, 128)])
def test_onehot_matmul_kernel_matches_plain(dev, out_f, in_f, rows):
    """Ragged OUT (a 37-wide one reads codes byte by byte), a ragged 64-wide
    input slab (IN 200), k/v's 64 columns; the GEMV form at <= 8 rows, the
    GEMM form above, layer 1 of stacked codes read in place."""
    gen = torch.Generator(device=dev).manual_seed(rows + out_f)
    codes, cb, scales = _onehot(gen, dev, out_f, in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((2, out_f), generator=gen, device=dev)
    before = _build.KERNELS["onehot_matmul"].launches
    got = k15.fused_onehot_matmul_indexed(x, codes, cb, scales, 1, bias, group=8)
    assert _build.KERNELS["onehot_matmul"].launches == before + 1
    want = k15.plain(x, codes[1], cb[1], scales[1]) + bias[1].to(torch.bfloat16)
    _close(got, want, steps=2)


@pytest.mark.parametrize("rows", [1, 5, 8])
def test_onehot_matmul_kernel_f32_activations(dev, rows):
    """f32 activations (GEMV form): the weight still rounds to bf16, the
    output stays f32; only the f32 sum's order differs from the plain version."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _onehot(gen, dev, 200, 512)
    x = torch.randn((rows, 512), generator=gen, device=dev)
    got = k15.fused_onehot_matmul(x, codes[0], cb[0], scales[0], group=8)
    want = k15.plain(x, codes[0], cb[0], scales[0])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_onehot_matmul_kernel_is_deterministic(dev):
    """The split-input reduction adds the splits in a fixed order."""
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _onehot(gen, dev, 4544, 18176, L=1)
    for rows in (4, 64):
        x = torch.randn((rows, 18176), generator=gen, device=dev).to(torch.bfloat16)
        a = k15.fused_onehot_matmul(x, codes[0], cb[0], scales[0], group=8)
        assert torch.equal(a, k15.fused_onehot_matmul(x, codes[0], cb[0], scales[0], group=8))


def _onehot_k(gen, dev, out_f, in_f, K, L=1):
    """Untiled Kx8 codes [L, K, IG, OUT] over the full byte range."""
    codes = torch.randint(0, 256, (L, K, in_f // 8, out_f), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((L, K, 256, 8), generator=gen, device=dev) / (4 * K ** 0.5)).to(torch.bfloat16)
    scales = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("rows", [1, 4, 8, 9, 64, 200, 1024])
@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("out_f", [64, 200, 4544])
def test_onehot_plan_branches_match_plain(dev, out_f, K, rows):
    """Every branch of onehot_plan: the GEMV (bf16 and f32 x; TMA code ring
    at OUT 64/4544, byte loads at OUT 200; split over the input groups at
    k/v and the wide projections) and the GEMM (BM 128 and 256, split and
    unsplit, 16- or 4-byte code copies), two bf16 steps from the plain
    version (f32 x: the f32 sum's order only)."""
    gen = torch.Generator(device=dev).manual_seed(rows * 7 + K + out_f)
    in_f = 4544
    codes, cb, scales = _onehot_k(gen, dev, out_f, in_f, K)
    x = torch.randn((rows, in_f), generator=gen, device=dev)
    for xt in ((x.to(torch.bfloat16), x) if rows <= 8 else (x.to(torch.bfloat16),)):
        got = k15.launch(xt, codes[0], cb[0], scales[0], 8)
        want = k15.plain(xt, codes[0], cb[0], scales[0])
        assert got.dtype == xt.dtype
        if xt.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        else:
            _close(got, want, steps=2)


def test_onehot_plan_branches_are_covered():
    """The cases above reach every plan branch."""
    seen = set()
    for out_f in (64, 200, 4544):
        for K in (1, 2, 8):
            for rows in (1, 4, 8, 9, 64, 200, 1024):
                p = k15.onehot_plan(rows, out_f, 4544 // 8, K)
                seen.add((p.path, p.bm, p.splits > 1, out_f % 16 == 0))
    assert {("gemv", 0, True, True), ("gemv", 0, True, False), ("gemm", 128, True, True),
            ("gemm", 256, True, True), ("gemm", 256, False, True), ("gemm", 128, True, False)} <= seen


@pytest.mark.parametrize("rows", [4, 64, 1024])
def test_onehot_split_runs_are_bit_identical(dev, rows):
    """A second run gives identical bits: the warps and the input splits
    meet in a fixed order."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    for out_f in (64, 4544):
        codes, cb, scales = _onehot_k(gen, dev, out_f, 18176, 2)
        x = torch.randn((rows, 18176), generator=gen, device=dev).to(torch.bfloat16)
        a = k15.launch(x, codes[0], cb[0], scales[0], 8)
        for _ in range(2):
            assert torch.equal(a, k15.launch(x, codes[0], cb[0], scales[0], 8))


def test_onehot_matmul_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _onehot(gen, dev, 64, 256, L=1)
    with pytest.raises(ValueError, match="bf16 activations"):  # f32 above 8 rows
        k15.fused_onehot_matmul(torch.randn((9, 256), device=dev), codes[0], cb[0], scales[0],
                                group=8)
    x = torch.randn((4, 256), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k15.launch(x, codes[0].transpose(1, 2).contiguous().transpose(1, 2), cb[0], scales[0], 8)
    with pytest.raises(ValueError, match="f32 scales"):
        k15.fused_onehot_matmul(x, codes[0], cb[0], scales[0].to(torch.bfloat16), group=8)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rep,d", [(3, 128), (6, 64), (71, 64)])
def test_flash_decode_kernel_chunked_heads_match_plain(dev, rep, d, quantized, window):
    """Query heads per kv head outside 1/2/4/8 run split-KV on the tensor
    cores (71: five 16-head mma tiles, the last one 7 wide), every block
    taking the new row from k_new/v_new and the split holding it writing it:
    the output and the written cache match the plain version."""
    gen = torch.Generator(device=dev).manual_seed(rep)
    L, B, H, S = 2, 4, 1 if rep == 71 else 2, 2048
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, H * rep, d), generator=gen, device=dev)
    if quantized:
        kv = [torch.randint(-127, 128, (L, B, H, S, d), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8) for _ in range(2)]
        sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        new = [torch.randint(-127, 128, (B, 1, H, d), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8) for _ in range(2)]
        nsc = [torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50 for _ in range(2)]
    else:
        kv = [torch.randn((L, B, H, S, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2)]
        sc = nsc = [None, None]
        new = [torch.randn((B, 1, H, d), generator=gen, device=dev) for _ in range(2)]
    ref = [[None if t is None else t.cpu() for t in pair] for pair in (kv, sc)]
    before = _build.KERNELS["flash_decode_write"].launches
    got = fd.flash_decode_write_attention_indexed(q, new[0], new[1], kv[0], kv[1], sc[0], sc[1], 1,
                                                  offsets, k_scale_new=nsc[0], v_scale_new=nsc[1],
                                                  window=window)
    assert _build.KERNELS["flash_decode_write"].launches == before + 1
    want = fd.flash_decode_write_attention_indexed(
        q.cpu(), new[0].cpu(), new[1].cpu(), ref[0][0], ref[0][1], ref[1][0], ref[1][1], 1,
        offsets.cpu(), k_scale_new=None if nsc[0] is None else nsc[0].cpu(),
        v_scale_new=None if nsc[1] is None else nsc[1].cpu(), window=window)
    _close(got[0].cpu(), want[0])
    for t, r in zip(got[1:], want[1:]):
        if r is not None:
            assert torch.equal(t.cpu(), r)


def test_falcon_engine_on_the_card_launches_its_kernels(dev):
    """A narrow Falcon in codes mode (OUT 320 and 64: untiled; fc1 1024:
    tiled) runs B15 for q/k/v/o/fc2, K1/K2 for fc1, K3 at 5 query heads
    per kv head, and nothing else: five B15 launches per K1/K2 launch."""
    from aqlm_tpu_torch.models.falcon import FalconConfig

    cfg = FalconConfig.tiny(num_layers=2, hidden_size=320, intermediate_size=1024, num_heads=5,
                            num_kv_heads=1)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8)
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True))
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    n = {name: info.launches for name, info in _build.KERNELS.items()}
    assert all(n[k] > 0 for k in CODES_KERNELS + ("onehot_matmul",))
    assert n["onehot_matmul"] == 5 * (n["lut_gemv"] + n["gather_prefill"])
    assert all(v == 0 for name, v in n.items() if name not in CODES_KERNELS + ("onehot_matmul",))


# (E, OUT, IN): split-K at E=2, OUT=128; Mixtral-8x7B's gate/up and down
MOE_CODES_SHAPES = [(2, 128, 4096), (8, 14336, 4096), (8, 4096, 14336)]


def _moe_codes(gen, dev, E, out_f, in_f, L=2):
    tn = lg.lut_tile_n(out_f)
    codes = torch.randint(0, 256, (L, E, out_f // tn, in_f // 8 * 2, tn), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((L, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand((L, E, out_f), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("shape", MOE_CODES_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lut_moe_gemv_kernel_matches_plain(dev, shape, rows, per_expert):
    """K1's MoE instance, layer-indexed and unstacked, bf16 and f32 x: f32
    out within one bf16 step of the f32-weight plain version."""
    E, out_f, in_f = shape
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _moe_codes(gen, dev, E, out_f, in_f)
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen, device=dev)
    for xt in (x.to(torch.bfloat16), x):
        before = _build.KERNELS["lut_moe_gemv"].launches
        got = lg.lut_moe_gemv_kx8_indexed(xt, codes, cb, scales, 1, group=8)
        assert _build.KERNELS["lut_moe_gemv"].launches == before + 1
        assert got.shape == (E, rows, out_f) and got.dtype == torch.float32
        _close(got, lg.moe_plain(xt, codes[1], cb[1], scales[1]))
        _close(lg.lut_moe_gemv_kx8(xt, codes[0], cb[0], scales[0], group=8),
               lg.moe_plain(xt, codes[0], cb[0], scales[0]))


def test_lut_moe_gemv_kernel_is_deterministic(dev):
    """Split-K at E=2, OUT=128; each expert agrees with the dense K1 on it."""
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _moe_codes(gen, dev, 2, 128, 4096, L=1)
    x = torch.randn((2, 4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    a = lg.lut_moe_gemv_kx8(x, codes[0], cb[0], scales[0], group=8)
    assert torch.equal(a, lg.lut_moe_gemv_kx8(x, codes[0], cb[0], scales[0], group=8))
    for e in range(2):
        _close(a[e], lg.launch(x[e], codes[0, e], cb[0, e][None], scales[0, e], None,
                               torch.float32, 8))


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [9, 64, 200])
@pytest.mark.parametrize("shape", MOE_CODES_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_moe_gather_prefill_kernel_matches_plain(dev, shape, rows, per_expert):
    """Past 8 rows: K2's f32 instance over every expert in one launch (its
    expert grid axis), against K2's plain version with an f32 output, and
    against the f32-weight function (the plain version on the CPU) within the
    bf16 weight's rounding bound 2^-8 * (|x| @ |W|^T) * scale + 1e-3
    max|plain|."""
    E, out_f, in_f = shape
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _moe_codes(gen, dev, E, out_f, in_f)
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen,
                    device=dev).to(torch.bfloat16)
    before = _build.KERNELS["moe_gather_prefill"].launches
    got = lg.lut_moe_gemv_kx8_indexed(x, codes, cb, scales, 1, group=8)
    assert _build.KERNELS["moe_gather_prefill"].launches == before + 1
    assert got.shape == (E, rows, out_f) and got.dtype == torch.float32
    want = torch.stack([gp.plain(x[e] if per_expert else x, codes[1, e], cb[1, e][None],
                                 scales[1, e], None, torch.float32) for e in range(E)])
    _close(got, want)
    f32_w = lg.moe_plain(x, codes[1], cb[1], scales[1])
    xs = [x[e] if per_expert else x for e in range(E)]
    bound = torch.stack([xs[e].float().abs() @ lg.dequant_tiled_t(codes[1, e], cb[1, e][None]).to(
        torch.bfloat16).float().abs() * scales[1, e] for e in range(E)]) * 2 ** -8
    assert bool(((got - f32_w).abs() <= bound + 1e-3 * f32_w.abs().max()).all())


def test_lut_moe_gemv_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _moe_codes(gen, dev, 2, 256, 1024, L=1)
    x = torch.randn((4, 1024), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="E=2"):
        lg.lut_moe_gemv_kx8(torch.stack([x] * 3), codes[0], cb[0], scales[0], group=8)
    with pytest.raises(ValueError, match="do not match"):
        lg.lut_moe_gemv_kx8(x, codes[0], cb[0], scales[0, :, :128].contiguous(), group=8)
    with pytest.raises(NotImplementedError, match="in_group_size 8"):
        lg.lut_moe_gemv_kx8(x, codes[0], cb[0], scales[0], group=16)
    with pytest.raises(ValueError, match="bf16 activations"):  # K2's route takes bf16 only
        lg.lut_moe_gemv_kx8(torch.randn((9, 1024), device=dev), codes[0], cb[0], scales[0], group=8)


def test_gather_prefill_f32_instance_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _codes(gen, dev, (512,), 4096)
    x = torch.randn((77, 4096), generator=gen, device=dev).to(torch.bfloat16)
    got = gp.launch(x, codes[0], cb[0], scales[0], None, 8, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, gp.plain(x, codes[0], cb[0], scales[0], None, torch.float32))
    _close(got.to(torch.bfloat16), gp.launch(x, codes[0], cb[0], scales[0], None, 8))


def _g16(gen, dev, out_f, in_f, group, L=2):
    codes = torch.randint(-32768, 32768, (L, out_f, in_f // group), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16)
    cb = (torch.randn((L, 65536 * group // 128, 128), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 77, 200])
@pytest.mark.parametrize("out_f,in_f,group", [(4096, 4096, 8), (4096, 11008, 8), (520, 1024, 8),
                                              (256, 4096, 16), (200, 2048, 16)])
def test_gather16_kernels_match_plain(dev, out_f, in_f, group, rows):
    """The GEMV (<= 8 rows, bf16 and f32 x) and the GEMM (bf16 x), stacked
    (a layer view) and with a bias (two steps: it is added after, in x's
    dtype); a ragged OUT (520, 200) masks the GEMM's last tile."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _g16(gen, dev, out_f, in_f, group)
    bias = torch.randn((2, out_f), generator=gen, device=dev)
    x = torch.randn((rows, in_f), generator=gen, device=dev)
    kernel = "gather16_gemv" if rows <= 8 else "gather16_gemm"
    for xt in ((x.to(torch.bfloat16), x) if rows <= 8 else (x.to(torch.bfloat16),)):
        before = _build.KERNELS[kernel].launches
        got = g16.gather_matmul_16_indexed(xt, codes, cb, scales, 1, group=group)
        assert _build.KERNELS[kernel].launches == before + 1 and got.dtype == xt.dtype
        want = g16.plain(xt, codes[1], cb[1], scales[1], group)
        _close(got, want)
        _close(g16.gather_matmul_16_indexed(xt, codes, cb, scales, 1, bias, group=group),
               want + bias[1].to(want.dtype), steps=2)


def test_gather16_kernels_are_deterministic(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _g16(gen, dev, 256, 4096, 8, L=1)
    for rows in (4, 64):  # the GEMM at 64 rows splits its input over blocks
        x = torch.randn((rows, 4096), generator=gen, device=dev).to(torch.bfloat16)
        a = g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=8)
        assert torch.equal(a, g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=8))


@pytest.mark.parametrize("rows", [1, 4, 8, 9, 63, 64, 65, 256, 257, 1024])
@pytest.mark.parametrize("group", [8, 16])
def test_gather16_plan_rows_match_plain(dev, group, rows):
    """Llama-2-7B's down at every row count the plan treats apart: the GEMV
    (bf16 x staged, f32 x at 8 rows read from device memory), the pre-pass
    and GEMM at BM 128 and 256, split (T 9-257) and unsplit (T 1024); codes
    over the full uint16 range; one bf16 step (f32 x: the sum's order only)."""
    gen = torch.Generator(device=dev).manual_seed(rows + group)
    codes, cb, scales = _g16(gen, dev, 4096, 11008, group, L=1)
    x = torch.randn((rows, 11008), generator=gen, device=dev)
    for xt in ((x.to(torch.bfloat16), x) if rows <= 8 else (x.to(torch.bfloat16),)):
        got = g16.gather_matmul_16(xt, codes[0], cb[0], scales[0], group=group)
        want = g16.plain(xt, codes[0], cb[0], scales[0], group)
        if xt.dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        else:
            _close(got, want)


@pytest.mark.parametrize("rows", [1, 5, 8, 9, 300])
@pytest.mark.parametrize("group", [8, 16])
def test_gather16_odd_out_matches_plain(dev, group, rows):
    """An odd OUT: the g=16 GEMV's last row pair holds one row, the GEMM
    stores its last column alone."""
    gen = torch.Generator(device=dev).manual_seed(rows * 3 + group)
    codes, cb, scales = _g16(gen, dev, 201, 1024, group, L=1)
    x = torch.randn((rows, 1024), generator=gen, device=dev).to(torch.bfloat16)
    _close(g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=group),
           g16.plain(x, codes[0], cb[0], scales[0], group))


def test_gather16_plan_rows_cover_every_branch():
    """The cases above and below reach every plan branch: the first design
    (g=8, g=16 past 4 rows), the lane-pair kernel with x staged and read
    from device memory, the GEMM at BM 128 and 256, split and unsplit."""
    seen = set()
    for group in (8, 16):
        for rows in (1, 4, 8, 9, 63, 64, 65, 256, 257, 1024):
            for dt in (torch.bfloat16, torch.float32) if rows <= 8 else (torch.bfloat16,):
                p = g16.plan(rows, 4096, 11008 // group, group, 132, dt)
                first = p.path == "gemv" and (group == 8 or rows > 4)
                seen.add((p.path, p.bm, p.splits > 1, p.x_staged, first))
    p = g16.plan(4, 512, 20480 // 16, 16, 132, torch.float32)
    seen.add((p.path, p.bm, p.splits > 1, p.x_staged, False))
    assert {("gemv", 0, False, True, True), ("gemv", 0, False, True, False),
            ("gemv", 0, False, False, False), ("gemm", 128, True, False, False),
            ("gemm", 256, True, False, False), ("gemm", 256, False, False, False)} <= seen


@pytest.mark.parametrize("rows", [3, 4])
def test_gather16_pair_gemv_unstaged_x_matches_plain(dev, rows):
    """f32 x too wide to stage (IN 20480 at g=16): the lane-pair kernel reads
    x from device memory."""
    assert not g16.plan(rows, 512, 20480 // 16, 16, 132, torch.float32).x_staged
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes, cb, scales = _g16(gen, dev, 512, 20480, 16, L=1)
    x = torch.randn((rows, 20480), generator=gen, device=dev)
    got = g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=16)
    want = g16.plain(x, codes[0], cb[0], scales[0], 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_gather16_gemm_second_run_is_bit_identical(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    codes, cb, scales = _g16(gen, dev, 4096, 11008, 8, L=1)
    for rows in (9, 64, 257):
        x = torch.randn((rows, 11008), generator=gen, device=dev).to(torch.bfloat16)
        a = g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=8)
        for _ in range(2):
            assert torch.equal(a, g16.gather_matmul_16(x, codes[0], cb[0], scales[0], group=8))


def test_gather16_wrapper_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    codes, cb, scales = _g16(gen, dev, 256, 1024, 8, L=1)
    x = torch.randn((4, 1024), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="8 or 16"):
        g16.gather_matmul_16(x[:, :512], codes[0][:, :128].contiguous(), cb[0], scales[0], group=4)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        g16.gather_matmul_16(x[:, :96].contiguous(), codes[0][:, :12].contiguous(), cb[0],
                             scales[0], group=8)
    with pytest.raises(ValueError, match="int16 codes"):
        g16.gather_matmul_16(x, codes[0].to(torch.int32), cb[0], scales[0], group=8)
    with pytest.raises(ValueError, match="bf16 activations"):
        g16.gather_matmul_16(torch.randn((9, 1024), device=dev), codes[0], cb[0], scales[0], group=8)


def test_mixtral_codes_engine_on_the_card_launches_its_kernels(dev):
    """Caller-stacked 2x8 codes experts: K1's MoE instance 3 times per layer
    per decode forward, K2's f32 instance (all experts in one launch) 3 times
    per layer per prefill forward, K1/K2 on the fused attention, K3; nothing
    else."""
    cfg = mixtral.MixtralConfig.tiny_moe(num_layers=2, hidden_size=256, intermediate_size=512,
                                         num_heads=4, num_kv_heads=2, num_experts=3)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8)
    params["layers"] = [mixtral.stack_experts(l, cfg, donate=True) for l in params["layers"]]
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True, donate_params=True))
    assert isinstance(engine.params["layers"]["experts_up_proj"], mixtral.StackedCodesExperts)
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    n = {name: info.launches for name, info in _build.KERNELS.items()}
    L = cfg.num_layers
    decode, prefill = n["flash_decode_write"] // L, n["gather_prefill"] // (2 * L)
    assert decode > 0 and prefill > 0
    assert n["lut_moe_gemv"] == 3 * L * decode and n["lut_gemv"] == 2 * L * decode
    assert n["moe_gather_prefill"] == 3 * L * prefill
    mine = CODES_KERNELS + ("lut_moe_gemv", "moe_gather_prefill")
    assert all(v == 0 for name, v in n.items() if name not in mine)


def test_1x16_engine_on_the_card_launches_its_kernels(dev):
    """Llama in 1x16 codes: seven unfused projections per layer on the 1x16
    GEMV (decode) or GEMM (prefill), K3; nothing else."""
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=512,
                                 num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_1X16)
    engine = Engine(params, cfg, ServeConfig(max_batch=2, max_len=128, prefill_buckets=(16, 32),
                                             kv_quantized=True))
    _build.reset_launch_counts()
    out = engine.generate([np.arange(5), np.arange(40)], SamplingParams(max_new_tokens=4))
    assert [len(o) for o in out] == [4, 4]
    n = {name: info.launches for name, info in _build.KERNELS.items()}
    L = cfg.num_layers
    assert n["gather16_gemv"] == 7 * L * (n["flash_decode_write"] // L) > 0
    assert n["gather16_gemm"] > 0 and n["gather16_gemm"] % (7 * L) == 0
    mine = ("gather16_gemv", "gather16_gemm", "flash_decode_write")
    assert all(v == 0 for name, v in n.items() if name not in mine)


# --- B13 / B14: the differentiable dequant of calibration ----------------------------------


def _unaligned(t):
    """A contiguous copy of uint8 ``t`` whose data starts one byte past an
    aligned address (the kernels then read each group's codes byte by byte)."""
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# B13: K 1/2/4/8 (one vector load of a group's codes) and 3 (byte loads); g 8
# and 16 (float4 lanes, two or four a group), 4, 12, 3 and 5 (g % 4 != 0:
# float lanes); S 16 and 256; odd group counts
B13_SHAPES = [(1, 129, 16, 8, 256), (2, 333, 37, 8, 256), (8, 65, 9, 8, 256), (2, 31, 5, 4, 256),
              (2, 17, 6, 3, 256), (4, 65, 9, 16, 256), (2, 77, 13, 16, 16), (3, 40, 7, 8, 256),
              (2, 50, 4, 12, 64), (5, 7, 3, 5, 32), (1, 3, 1, 8, 16)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("K,og,ig,g,S", B13_SHAPES)
def test_dequantize_kernel_matches_plain(dev, K, og, ig, g, S, precise):
    """B13 against its plain version: bit-identical (the same f32 adds in
    codebook order from zero), with and without scales, with codes aligned
    for one load a group and one byte past it."""
    gen = torch.Generator(device=dev).manual_seed(K * og + S)
    codes = torch.randint(0, S, (og, ig, K), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = torch.randn((K, S, g), generator=gen, device=dev)
    scales = torch.rand(og, generator=gen, device=dev) + 0.5
    before = _build.KERNELS["dequantize_onehot"].launches
    for c in (codes, _unaligned(codes)):
        for sc in (None, scales):
            got = k15.dequant_launch(c, cb, sc, precise=precise)
            assert torch.equal(got, k15.dequant_plain(codes, cb, sc, precise=precise))
    assert _build.KERNELS["dequantize_onehot"].launches == before + 4


def test_dequantize_kernel_cuts_runs_of_2g_floats(dev):
    """A W of more than 2^31 - 1 floats (8.6 GB) runs in two runs of whole
    rows, each indexed in 32 bits: the rows either side of the cut, the
    first and the last agree with the plain version bit for bit (scaled,
    so each run's scales pointer is checked too)."""
    ig, K, g = 512, 2, 8
    rows_per_run = (2 ** 31 - 1) // (ig * g)  # the kernel's run of whole rows
    og = rows_per_run + 2
    gen = torch.Generator(device=dev).manual_seed(9)
    codes = torch.randint(0, 256, (og, ig, K), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = torch.randn((K, 256, g), generator=gen, device=dev)
    scales = torch.rand(og, generator=gen, device=dev) + 0.5
    got = k15.dequant_launch(codes, cb, scales)
    for r in (0, rows_per_run - 1, rows_per_run, og - 1):
        want = k15.dequant_plain(codes[r:r + 1], cb, scales[r:r + 1])
        assert torch.equal(got[r:r + 1], want), r
    del got, codes
    torch.cuda.empty_cache()


# B14: K 1/2/3/4/5/8; S 16, 64, 256 and 512 (uint8 codes fill the first 256
# segments, the rest must come out 0); g 1, 2, 3, 4, 8, 16, 32 and 1500
# (a float2 a thread at even g, a float at odd; bank-interleaved copies and
# one shared copy; a thread's columns wrapping past 2 x 1024); G 0 and 1,
# below one block's share (one block, written straight to the output), a few
# blocks (one merge chunk), more than 16 blocks (several chunks) and one
# block an SM
CB_GRAD_SHAPES = [(1, 16, 1001, 8), (2, 256, 77777, 8), (8, 256, 4099, 8), (2, 512, 30001, 8),
                  (3, 16, 513, 4), (4, 256, 600001, 16), (5, 64, 50000, 3), (2, 256, 0, 8),
                  (1, 256, 1, 8), (2, 256, 2000003, 8), (3, 64, 200000, 8), (2, 256, 100000, 32),
                  (2, 256, 1048576, 1), (2, 256, 300007, 2), (1, 4, 3001, 1500),
                  (2, 256, 13, 8), (4, 16, 29, 8)]


def _cb_grad_check(got, codes, data, precise):
    """Within 1e-5 of each segment's sum of |data| of a float64 sum (of the
    bf16-rounded data when not precise)."""
    K, S, g = got.shape
    d64 = (data if precise else data.to(torch.bfloat16).float()).double()
    want = torch.zeros((K, S, g), dtype=torch.float64, device=data.device)
    mass = torch.zeros_like(want)
    for k in range(K):
        want[k].index_add_(0, codes[:, k].long(), d64)
        mass[k].index_add_(0, codes[:, k].long(), d64.abs())
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - want).abs() <= 1e-5 * mass).all())


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("K,S,G,g", CB_GRAD_SHAPES)
def test_cb_grad_kernel_matches_float64(dev, K, S, G, g, precise):
    """B14 within 1e-5 of each segment's sum of |data| of a float64 sum, with
    codes aligned for one load a group and one byte past it, and data
    aligned for float2 lanes and one float past it (float lanes)."""
    gen = torch.Generator(device=dev).manual_seed(G + K)
    codes = torch.randint(0, min(S, 256), (G, K), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    data = torch.randn((G, g), generator=gen, device=dev)
    shifted = torch.empty(G * g + 1, device=dev)[1:].view(G, g)
    shifted.copy_(data)
    before = _build.KERNELS["cb_grad_segment"].launches
    for c, d in ((codes, data), (_unaligned(codes), shifted)):
        _cb_grad_check(k15.cb_grad_segment(c, d, S, precise=precise), codes, data, precise)
    assert _build.KERNELS["cb_grad_segment"].launches == before + 2


def test_cb_grad_cases_cover_every_plan_branch(dev):
    """The shapes above reach one block and several, one merge chunk,
    several and a block an SM, float2 and float lanes, bank-interleaved
    copies and one shared copy."""
    sms = _build.sm_count(dev.index)
    plans = [k15.cb_grad_plan(G, K, S, g, sms, pairs)
             for K, S, G, g in CB_GRAD_SHAPES for pairs in (True, False)]
    assert {p.blocks == 1 for p in plans} == {True, False}
    chunks = {-(-p.blocks // 16) for p in plans if p.blocks > 1}  # the merge's chunks of 16 slices
    assert chunks >= {1, 2, -(-sms // 16)}
    assert max(p.blocks for p in plans) == min(sms, 256)
    assert {(p.vec, p.slots > 1) for p in plans} == {(v, i) for v in (1, 2) for i in (False, True)}


def test_cb_grad_back_to_back_and_on_two_streams(dev):
    """Launches back to back on one stream share its partial sums, and
    launches on two streams at once keep their own: every result holds
    against its own float64 sum."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for G in (600001, 300007):
        codes = torch.randint(0, 256, (G, 2), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cases.append((codes, torch.randn((G, 8), generator=gen, device=dev)))
    outs = [k15.cb_grad_segment(c, d, 256) for c, d in cases for _ in range(2)]
    for i, got in enumerate(outs):
        _cb_grad_check(got, *cases[i // 2], True)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(6):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(k15.cb_grad_segment(*cases[i], 256))
    torch.cuda.synchronize(dev)
    for case, got in zip(cases, outs):
        for o in got:
            _cb_grad_check(o, *case, True)


def _kernel_names(fn):
    """The names of the device activities (kernels, memsets, copies) of one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_calib_kernels_allocate_only_their_output_and_set_no_memory(dev):
    """After a first launch, a B13 or B14 launch allocates its output and
    nothing else, issues no synchronising call and no memset; B14 at a
    shape of many blocks and at a small one runs its kernel and the merge."""
    gen = torch.Generator(device=dev).manual_seed(12)
    codes = torch.randint(0, 256, (4096, 512, 2), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = torch.randn((2, 256, 8), generator=gen, device=dev)
    flat = codes.reshape(-1, 2)
    data = torch.randn((flat.shape[0], 8), generator=gen, device=dev)
    runs = {"b13": lambda: k15.dequant_launch(codes, cb),
            "b14": lambda: k15.cb_grad_launch(flat, data, 256),
            "b14_small": lambda: k15.cb_grad_launch(flat[:300], data[:300], 256)}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize(dev)
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs + 1, name
        names = _kernel_names(run)
        assert not [n for n in names if "emset" in n or "emcpy" in n], (name, names)
        kernels = sorted(k for n in names for k in ("dequant4_kernel", "dequant1_kernel",
                                                    "cb_grad_kernel", "cb_grad_merge_kernel")
                         if re.search(rf"\b{k}\b", n))
        want = {"b13": ["dequant4_kernel"], "b14": ["cb_grad_kernel", "cb_grad_merge_kernel"],
                "b14_small": ["cb_grad_kernel", "cb_grad_merge_kernel"]}[name]
        assert kernels == want, (name, names)


def test_dequant_wrappers_raise(dev):
    codes = torch.zeros((4, 2, 2), dtype=torch.uint8, device=dev)
    cb = torch.zeros((2, 256, 8), device=dev)
    with pytest.raises(ValueError, match="f32 codebooks"):
        k15.dequant_launch(codes, cb.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bad shapes"):
        k15.dequant_launch(codes, torch.zeros((2, 256, 128), device=dev))  # 256 KB of codebooks
    with pytest.raises(ValueError, match="bad shapes"):
        k15.cb_grad_launch(codes.reshape(-1, 2), torch.zeros((8, 8), device=dev), 513)
    with pytest.raises(ValueError, match="uint8 codes"):
        k15.cb_grad_launch(codes.reshape(-1, 2).to(torch.int16), torch.zeros((8, 8), device=dev),
                           256)


def test_reference_matmul_on_the_card_runs_b13_and_b14(dev):
    """Reference mode on the card dequantizes through B13 and its backward
    runs B14, as on the TPU; the plain path on the CPU launches neither.
    Values and codebook/scale gradients of a loss linear in y, on the card
    and on the CPU in f32, lie within 1e-5 x each element's sum of |terms|
    of the float64 plain path (the sums of |terms| are that path run on
    |inputs|, which the loss's linearity allows)."""
    from aqlm_tpu_torch.ops.dequant import random_aqlm_weight
    from aqlm_tpu_torch.ops.runtime import QuantizedLinear, quantized_matmul

    w = random_aqlm_weight(torch.Generator().manual_seed(0), SCHEME_2X8, 256, 512, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 512), generator=gen)
    r = torch.randn((3, 256), generator=gen)

    def run(d, dtype, absolute=False):
        f = (lambda t: t.abs()) if absolute else (lambda t: t)
        cb = f(w.codebooks).to(d, dtype).requires_grad_(True)
        sc = f(w.scales).to(d, dtype).requires_grad_(True)
        q = QuantizedLinear(codes=w.codes.to(d), codebooks=cb, scales=sc, bias=None,
                            scheme=SCHEME_2X8, mode="reference")
        _build.reset_launch_counts()
        y = quantized_matmul(f(x).to(d, dtype), q)
        g = torch.autograd.grad((y * f(r).to(d, dtype)).sum(), [cb, sc])
        launches = (_build.KERNELS["dequantize_onehot"].launches,
                    _build.KERNELS["cb_grad_segment"].launches)
        return [t.detach().cpu().double() for t in (y, *g)], launches

    exact, _ = run("cpu", torch.float64)
    mass, _ = run("cpu", torch.float64, absolute=True)
    cpu, cpu_launches = run("cpu", torch.float32)
    card, card_launches = run(dev, torch.float32)
    assert cpu_launches == (0, 0) and card_launches == (1, 1)
    for got in (card, cpu):
        for a, want, m in zip(got, exact, mass):
            assert bool(((a - want).abs() <= 1e-5 * m).all())


# --- B5 / B10: the serving layouts' activation backward (LoRA through frozen backbones) ----


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,out_f,in_f", [(2, 128, 64), (1, 512, 4096), (2, 4096, 4096),
                                          (2, 11008, 4096), (2, 4096, 11008), (2, 384, 8 * 37)])
def test_gather_dequant_wt_kernel_matches_plain(dev, K, out_f, in_f, out_dtype):
    """B5 bit-identical to its plain version (the same f32 adds in codebook
    order from k = 0, the same scale product, one rounding): OUT 128 to
    11008 (tiles of 128 and 512), a ragged IN (37 groups), K 1 and 2."""
    gen = torch.Generator(device=dev).manual_seed(K * out_f + in_f)
    codes_t = torch.randint(0, 256, (K, in_f // 8, out_f), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    codes = lg.tile_codes(codes_t)
    cb = (torch.randn((K, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand(out_f, generator=gen, device=dev) + 0.5
    before = _build.KERNELS["gather_dequant_wt"].launches
    got = gp.gather_dequant_wt(codes, cb, scales, dtype=out_dtype)
    assert _build.KERNELS["gather_dequant_wt"].launches == before + 1
    assert got.dtype == out_dtype and got.shape == (in_f, out_f)
    assert torch.equal(got, gp.dequant_wt_plain(codes, cb, scales, out_dtype))


def test_gather_dequant_wt_small_codebooks(dev):
    """S 16 (a 1x4-bit codebook of the Kx8 layout) and K 8."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for K, S in ((1, 16), (8, 256)):
        codes = lg.tile_codes(torch.randint(0, S, (K, 16, 256), generator=gen, device=dev,
                                            dtype=torch.int32).to(torch.uint8))
        cb = torch.randn((K, S, 8), generator=gen, device=dev).to(torch.bfloat16)
        scales = torch.rand(256, generator=gen, device=dev) + 0.5
        assert torch.equal(gp.gather_dequant_wt(codes, cb, scales),
                           gp.dequant_wt_plain(codes, cb, scales))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", range(1, 9))
@pytest.mark.parametrize("ig_count", [1, 37])
@pytest.mark.parametrize("out_f", [128, 384, 640])
def test_gather_dequant_wt_edges_match_plain(dev, out_f, ig_count, K, out_dtype):
    """B5 at OUT 128, 384 and 640 (the last chunk's half-empty warp), IG 1
    and 37, K 1-8, S 16: bit-identical to its plain version, and a second
    run bitwise the first."""
    gen = torch.Generator(device=dev).manual_seed(out_f * 100 + ig_count * 10 + K)
    codes = lg.tile_codes(torch.randint(0, 16, (K, ig_count, out_f), generator=gen, device=dev,
                                        dtype=torch.int32).to(torch.uint8))
    cb = torch.randn((K, 16, 8), generator=gen, device=dev).to(torch.bfloat16)
    scales = torch.rand(out_f, generator=gen, device=dev) + 0.5
    got = gp.gather_dequant_wt(codes, cb, scales, dtype=out_dtype)
    assert got.shape == (ig_count * 8, out_f)
    assert torch.equal(got, gp.dequant_wt_plain(codes, cb, scales, out_dtype))
    assert torch.equal(got, gp.gather_dequant_wt(codes, cb, scales, dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gather_dequant_wt_unaligned_codes(dev, out_dtype):
    """Codes one byte off an 8-byte boundary take the kernel's byte loads."""
    gen = torch.Generator(device=dev).manual_seed(5)
    codes_t = torch.randint(0, 256, (2, 9, 640), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    tiled = lg.tile_codes(codes_t)
    buf = torch.empty(tiled.numel() + 1, dtype=torch.uint8, device=dev)
    codes = buf[1:].view(tiled.shape)
    codes.copy_(tiled)
    assert codes.is_contiguous() and codes.data_ptr() % 8 == 1
    cb = torch.randn((2, 256, 8), generator=gen, device=dev).to(torch.bfloat16)
    scales = torch.rand(640, generator=gen, device=dev) + 0.5
    assert torch.equal(gp.gather_dequant_wt(codes, cb, scales, dtype=out_dtype),
                       gp.dequant_wt_plain(tiled, cb, scales, out_dtype))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 8, 77, 200, 1024])
@pytest.mark.parametrize("out_f,in_f", [(4096, 4096), (11008, 4096), (4096, 11008), (200, 1152),
                                        (64, 48)])
def test_int8_matmul_transposed_kernel_matches_plain(dev, out_f, in_f, rows, g_dtype):
    """B10 within one bf16 step of its plain version (the f32 sum runs in
    another order); padded IN_pad (11008 -> 11264, 1152 -> 2048) comes out
    zero past IN; ragged rows, OUT and IN tiles."""
    gen = torch.Generator(device=dev).manual_seed(out_f + rows)
    ld = im.pad_in_features(in_f)
    w8 = torch.randint(-127, 128, (out_f, ld), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    w8[:, in_f:] = 0
    scale = torch.rand(out_f, generator=gen, device=dev) / (127 * out_f ** 0.5)
    g = torch.randn((rows, out_f), generator=gen, device=dev).to(g_dtype)
    before = _build.KERNELS["int8_matmul_transposed"].launches
    got = im.int8_matmul_transposed(g, w8, scale)
    assert _build.KERNELS["int8_matmul_transposed"].launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (rows, ld)
    assert not got[:, in_f:].any()
    _close(got, im.plain_t(g, w8, scale))


def test_int8_matmul_transposed_kernel_is_deterministic(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    w8 = torch.randint(-127, 128, (4096, 4096), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand(4096, generator=gen, device=dev)
    g = torch.randn((300, 4096), generator=gen, device=dev).to(torch.bfloat16)
    first = im.int8_matmul_transposed(g, w8, scale)
    for _ in range(3):
        assert torch.equal(im.int8_matmul_transposed(g, w8, scale), first)


def test_backward_wrappers_raise(dev):
    w8 = torch.zeros((64, 128), dtype=torch.int8, device=dev)
    scale = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="bf16 or f32 gradients"):
        im.launch_t(torch.zeros((2, 64), dtype=torch.float16, device=dev), w8, scale)
    with pytest.raises(ValueError, match="against w8"):
        im.launch_t(torch.zeros((2, 32), dtype=torch.bfloat16, device=dev), w8, scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        im.launch_t(torch.zeros((2, 60), dtype=torch.bfloat16, device=dev), w8[:60].contiguous(),
                    scale[:60].contiguous())
    codes = torch.zeros((1, 32, 128), dtype=torch.uint8, device=dev)
    cb = torch.zeros((2, 256, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16 codebooks"):
        gp.dequant_wt_launch(codes, cb.float(), torch.ones(128, device=dev))
    with pytest.raises(ValueError, match="do not match"):
        gp.dequant_wt_launch(codes, cb, torch.ones(64, device=dev))
    with pytest.raises(NotImplementedError, match="in_group_size 8"):
        gp.dequant_wt_launch(codes, torch.zeros((2, 256, 4), dtype=torch.bfloat16, device=dev),
                             torch.ones(128, device=dev))


@pytest.mark.parametrize("mode,kernel", [("int8", "int8_matmul_transposed"),
                                         ("codes", "gather_dequant_wt")])
def test_autograd_route_launches_the_backward_kernel(dev, mode, kernel, monkeypatch):
    """quantized_matmul's backward on a CUDA tensor launches B10 (int8) or B5
    (tiled codes), once per call, and never the plain version (which is made
    to raise here); dx within one bf16 step of the same function on the CPU."""
    from aqlm_tpu_torch.ops.dequant import random_aqlm_weight
    from aqlm_tpu_torch.ops.runtime import QuantizedLinear, quantized_matmul

    w = random_aqlm_weight(torch.Generator().manual_seed(0), SCHEME_2X8, 512, 1152, device="cpu")
    q_cpu = QuantizedLinear.from_aqlm(w, mode=mode)
    q = dataclasses.replace(q_cpu, **{n: None if getattr(q_cpu, n) is None
                                      else getattr(q_cpu, n).to(dev) for n in q_cpu.data_fields})
    x = torch.randn((33, 1152), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    gy = torch.randn((33, 512), generator=torch.Generator().manual_seed(2))
    xc = x.clone().requires_grad_(True)
    (quantized_matmul(xc, q_cpu).float() * gy).sum().backward()

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(im, "plain_t", refuse)
    monkeypatch.setattr(gp, "dequant_wt_plain", refuse)
    _build.reset_launch_counts()
    xd = x.to(dev).requires_grad_(True)
    (quantized_matmul(xd, q).float() * gy.to(dev)).sum().backward()
    assert _build.KERNELS[kernel].launches == 1
    assert xd.grad.shape == (33, 1152) and xd.grad.dtype == torch.bfloat16
    _close(xd.grad.cpu(), xc.grad)


def test_tiny_lora_step_launch_counts(dev):
    """One make_lora_step on a 2-layer codes model at T 16 (K2 forward) with
    adapters on q/k/v/o: K2 7 per layer, B5 7 per layer less layer 0's
    q/k/v (their input needs no gradient, so autograd never calls their
    backward); then an int8 model: the int8 kernel and B10 the same."""
    from aqlm_tpu_torch.models.common import LoraLinear
    from aqlm_tpu_torch.models.quantize import map_quantized_linears
    from aqlm_tpu_torch.pv import init_lora_state, make_lora_step

    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=512,
                                 num_heads=4, num_kv_heads=4)
    shapes = llama.projection_shapes(cfg)
    for mode, fwd, bwd in (("codes", "gather_prefill", "gather_dequant_wt"),
                           ("int8", "int8_matmul", "int8_matmul_transposed")):
        gen = torch.Generator(device=dev).manual_seed(0)
        p = random_quantized_params(gen, cfg, SCHEME_2X8, mode=mode, device=dev)
        p = map_quantized_linears(p, lambda li, name, q: LoraLinear(
            q, torch.randn((4, shapes[name][1]), generator=gen, device=dev) / 2,
            torch.zeros((q.out_features, 4), device=dev), 4.0)
            if name in ("q_proj", "k_proj", "v_proj", "o_proj") else q)
        state = init_lora_state(p, lambda t: torch.optim.Adam(t, lr=3e-3))
        step = make_lora_step(cfg)
        ids = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, device=dev)
        _build.reset_launch_counts()
        state, loss = step(state, ids)
        torch.cuda.synchronize()
        counts = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
        assert counts == {fwd: 7 * 2, bwd: 7 * 2 - 3}, counts
        assert bool(torch.isfinite(loss))


# --------------------------------------------------------------------------- K1, K2, B15 at 1 and 8 codebooks


def _codes_k(gen, dev, sizes, in_f, K):
    """Stacked tiled codes at K codebooks of 256 (2 layers), codebooks, scales."""
    tn = min(lg.lut_tile_n(s) for s in sizes)
    nt, kig = sum(sizes) // tn, in_f // 8 * K
    codes = torch.randint(0, 256, (2, nt, kig, tn), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((2, len(sizes), K, 256, 8), generator=gen, device=dev) / (2 * K)).to(
        torch.bfloat16)
    scales = torch.rand((2, sum(sizes)), generator=gen, device=dev) + 0.5
    return codes, cb, scales


@pytest.mark.parametrize("rows", [1, 8, 77])
@pytest.mark.parametrize("K", [1, 8])
def test_codes_kernels_at_1_and_8_codebooks(dev, K, rows):
    """K1 (<= 8 rows) and K2 (77 rows) over 1x8 and 8x8 codes (8x8: K1 holds
    32 KiB of codebooks in shared memory), and B15 over the untiled layout."""
    gen = torch.Generator(device=dev).manual_seed(K * 100 + rows)
    sizes, in_f = (256, 128, 128), 1024
    codes, cb, scales = _codes_k(gen, dev, sizes, in_f, K)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    kernel = "lut_gemv" if rows <= 8 else "gather_prefill"
    before = _build.KERNELS[kernel].launches
    if rows <= 8:
        got = lg.lut_gemv_kx8_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    else:
        got = gp.gather_prefill_matmul_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    assert _build.KERNELS[kernel].launches == before + 1
    pm = lg.proj_map_for(sizes, codes.shape[-1], dev)
    want = (lg.plain(x, codes[1], cb[1], scales[1], pm, torch.bfloat16) if rows <= 8
            else gp.plain(x, codes[1], cb[1], scales[1], pm))
    _close(got, want)

    ucodes = torch.randint(0, 256, (2, K, in_f // 8, 200), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    ucb = (torch.randn((2, K, 256, 8), generator=gen, device=dev) / (2 * K)).to(torch.bfloat16)
    uscales = torch.rand((2, 200), generator=gen, device=dev) + 0.5
    before = _build.KERNELS["onehot_matmul"].launches
    got = k15.fused_onehot_matmul_indexed(x, ucodes, ucb, uscales, 1, None, group=8)
    assert _build.KERNELS["onehot_matmul"].launches == before + 1
    _close(got, k15.plain(x, ucodes[1], ucb[1], uscales[1]), steps=2)


# --------------------------------------------------------------------------- B6 and B8


def _decode_cache(gen, dev, quantized, L, B, H, S, d):
    if quantized:
        kv = [torch.randint(-127, 128, (L, B, H, S, d), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8) for _ in range(2)]
        sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        return kv, sc
    return [torch.randn((L, B, H, S, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)], [None, None]


@pytest.mark.parametrize("window", [None, 40, 600])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rep,d", [(1, 128), (2, 64), (8, 128), (6, 64), (71, 64)])
def test_flash_decode_attention_kernel_matches_plain(dev, rep, d, quantized, window):
    """B6 (K3's loops without the write) over layer 1 of a stacked cache at
    lengths 0 (the mean of V over the TPU grid's visited tiles), 1, 512, 513
    and S; a window of 600 skips one of the four 512-key tiles. The cache is
    left as it was."""
    gen = torch.Generator(device=dev).manual_seed(rep + d)
    L, B, H, S = 2, 5, 1 if rep == 71 else 2, 2048
    lengths = torch.tensor([0, 1, 512, 513, S], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, H * rep, d), generator=gen, device=dev).to(torch.bfloat16)
    kv, sc = _decode_cache(gen, dev, quantized, L, B, H, S, d)
    ref = [None if t is None else t.clone() for t in kv + sc]
    before = _build.KERNELS["flash_decode"].launches
    got = fd.flash_decode_attention_indexed(q, kv[0], kv[1], sc[0], sc[1], 1, lengths,
                                            window=window)
    assert _build.KERNELS["flash_decode"].launches == before + 1
    cpu = lambda t: None if t is None else t.cpu()
    want = fd.flash_decode_attention_indexed(q.cpu(), *[cpu(t) for t in kv + sc], 1,
                                             lengths.cpu(), window=window)
    _close(got.cpu(), want)
    for t, r in zip(kv + sc, ref):
        if r is not None:
            assert torch.equal(t, r)
    layer1 = lambda t: None if t is None else t[1]
    one = fd.flash_decode_attention(q, *[layer1(t) for t in kv + sc], lengths, window=window)
    assert torch.equal(one, got)


def test_flash_decode_attention_wrapper_raises(dev):
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        fd.flash_decode_attention(q, k, k, None, None, torch.zeros(2, dtype=torch.int64,
                                                                   device=dev))
    with pytest.raises(ValueError, match="int8 or bf16"):
        fd.flash_decode_attention(q, k.float(), k.float(), None, None,
                                  torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="f32 scale planes"):
        fd.flash_decode_attention(q, k.to(torch.int8), k.to(torch.int8), None, None,
                                  torch.zeros(2, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.int8, 128), (torch.int8, 64),
                                     (torch.float32, 64), (torch.float16, 4)])
def test_kv_write_kernel_matches_plain(dev, dtype, d):
    """B8 bit-identical to indexed assignment; offsets outside [0, S) write
    nothing; rows of 16 bytes and more move by 16 bytes, 8-byte rows by 4."""
    gen = torch.Generator(device=dev).manual_seed(d)
    L, B, H, S = 3, 6, 4, 96
    cache = (torch.randn((L, B, H, S, d), generator=gen, device=dev) * 50).to(dtype)
    new = (torch.randn((B, H, 1, d), generator=gen, device=dev) * 50).to(dtype)
    offsets = torch.tensor([0, 95, 33, -1, 96, 7], dtype=torch.int32, device=dev)
    want = cache.cpu()
    want_out = kw.kv_write_inplace(want, new.cpu(), 2, offsets.cpu())
    before = _build.KERNELS["kv_write"].launches
    got = kw.kv_write_inplace(cache, new, 2, offsets)
    assert _build.KERNELS["kv_write"].launches == before + 1 and got is cache
    assert torch.equal(got.cpu(), want_out)


def test_kv_write4_kernel_matches_plain(dev):
    """One launch writes k, v and both f32 scale planes of the int8 cache."""
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, H, S, d = 4, 4, 32, 256, 128
    kv, sc = _decode_cache(gen, dev, True, L, B, H, S, d)
    new = [torch.randint(-127, 128, (B, H, 1, d), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8) for _ in range(2)]
    nsc = [torch.rand((B, H, 1, 1), generator=gen, device=dev) for _ in range(2)]
    offsets = torch.tensor([0, 255, 100, 256], dtype=torch.int32, device=dev)
    want = kw.kv_write4_inplace(*[t.cpu() for t in kv + sc + new + nsc], 3, offsets.cpu())
    before = _build.KERNELS["kv_write"].launches
    got = kw.kv_write4_inplace(*kv, *sc, *new, *nsc, 3, offsets)
    assert _build.KERNELS["kv_write"].launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# B8 planes: (dtype, row elements); D is the k/v row's width
def _kv_planes(d, n):
    return [(torch.float16 if d == 4 else torch.bfloat16, d), (torch.int8, d), (torch.float32, 1),
            (torch.uint8, 3)][:n]


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [4, 64, 128])
@pytest.mark.parametrize("b,h", [(1, 1), (2, 3), (4, 32), (8, 64)])
def test_kv_write_planes_match_plain(dev, b, h, d, n_planes):
    """B8 over 1-4 planes of mixed row widths in one launch (16-, 4- and
    1-byte words: fp16 rows of 8 bytes at D 4, bf16 and int8 rows, f32
    scales, 3-byte rows), B x H from 1 x 1 to 8 x 64: bit-identical to the
    plain version; offsets -1 and S write nothing."""
    gen = torch.Generator(device=dev).manual_seed(b * h * d + n_planes)
    S = 40
    caches, news = [], []
    for dtype, width in _kv_planes(d, n_planes):
        if dtype.is_floating_point:
            cache = (torch.randn((b, h, S, width), generator=gen, device=dev) * 50).to(dtype)
            new = (torch.randn((b, h, width), generator=gen, device=dev) * 50).to(dtype)
        else:
            lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
            cache = torch.randint(lo, hi, (b, h, S, width), generator=gen, device=dev,
                                  dtype=torch.int32).to(dtype)
            new = torch.randint(lo, hi, (b, h, width), generator=gen, device=dev,
                                dtype=torch.int32).to(dtype)
        caches.append(cache)
        news.append(new)
    offsets = torch.tensor([S - 1, -1, S, 0, 17, 5, 39, 2][:b], dtype=torch.int32, device=dev)
    want = [c.clone() for c in caches]
    kw.plain(want, news, offsets)
    before = _build.KERNELS["kv_write"].launches
    kw.launch(caches, news, offsets)
    assert _build.KERNELS["kv_write"].launches == before + 1
    for got, w in zip(caches, want):
        assert torch.equal(got, w)


def test_kv_write_wrapper_raises(dev):
    cache = torch.zeros((2, 2, 2, 8, 16), dtype=torch.int8, device=dev)
    new = torch.zeros((2, 2, 1, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int32"):
        kw.kv_write_inplace(cache, new, 0, torch.zeros(2, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="do not match"):
        kw.kv_write_inplace(cache, new[:, :, :, :8], 0, torch.zeros(2, dtype=torch.int32,
                                                                      device=dev))


def _count_syncs(fn, *args):
    """(fn(*args), the synchronising CUDA calls it made), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def test_int8_engine_decode_chunk_on_the_card(dev):
    """max_len 512 keeps K3 off for int8 layers: decode writes its rows with
    B8, one launch per layer per decode forward and none in prefill, and
    attends by the plain attention. Chunks of 4 give the tokens of single
    steps, and the forwards inside a chunk do not synchronise (a deliberate
    read-back, the counter's control, counts one)."""
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=256,
                                 num_heads=4, num_kv_heads=2)
    prompts = [np.arange(5), np.arange(40), np.arange(3, 20)]
    outs, syncs = [], []
    for chunk in (1, 4):
        params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                         SCHEME_2X8, mode="int8")
        engine = Engine(params, cfg, ServeConfig(max_batch=4, max_len=512, prefill_buckets=(16, 32),
                                                 kv_quantized=True, lm_head_int8=True,
                                                 decode_chunk=chunk))
        inner_chunk, inner_fwd, forwards = engine._decode_chunk, engine._forward_sample, []

        def counted(*args, inner=inner_chunk):
            out, n = _count_syncs(inner, *args)
            syncs.append(n)
            return out

        engine._decode_chunk = counted
        engine._forward_sample = lambda *a, inner=inner_fwd: forwards.append(1) or inner(*a)
        _build.reset_launch_counts()
        outs.append(engine.generate(prompts, SamplingParams(max_new_tokens=9)))
        n = {k: v.launches for k, v in _build.KERNELS.items()}
        assert n["kv_write"] == len(forwards) * cfg.num_layers
        assert n["flash_decode_write"] == n["flash_decode"] == 0 and n["int8_matmul"] > 0
    assert outs[0] == outs[1]
    assert syncs and all(s == 0 for s in syncs), syncs
    assert _count_syncs(lambda: torch.ones(1, device=dev).sum().item())[1] >= 1


# --------------------------------------------------------------------------- redesigned K2 and K3


@pytest.mark.parametrize("rows", [9, 64, 77, 200, 300, 1024])
@pytest.mark.parametrize("sizes,in_f", [((512,), 4096), ((256, 128, 128), 1024), ((128,), 11008)])
def test_gather_prefill_kernel_over_its_plans(dev, sizes, in_f, rows):
    """K2 at row counts that take both block heights (128, 256) and, for the
    narrow projections, the split input dimension: one launch, within one
    bf16 step of the plain version, and deterministic."""
    gen = torch.Generator(device=dev).manual_seed(rows + in_f)
    codes, cb, scales = _codes(gen, dev, sizes, in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    p = gp.plan(rows, sum(sizes), in_f, 2, 256, 1, torch.bfloat16, _build.sm_count(dev.index))
    before = _build.KERNELS["gather_prefill"].launches
    got = gp.gather_prefill_matmul_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    assert _build.KERNELS["gather_prefill"].launches == before + 1
    pm = lg.proj_map_for(sizes, codes.shape[-1], dev)
    _close(got, gp.plain(x, codes[1], cb[1], scales[1], pm))
    again = gp.gather_prefill_matmul_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    assert torch.equal(got, again), p


@pytest.mark.parametrize("splits", [1, 3, 16, 32])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rep,d", [(71, 64), (6, 128)])
def test_flash_decode_split_count_sweep(dev, rep, d, quantized, splits):
    """The split-KV kernels at a forced split count: K3 (offsets 0/511/512/
    1999, window none and 256) and B6 (lengths 0/1/512/2048: length 0 is the
    mean of V over the visited tiles, however the keys are split) against
    their plain versions; the written cache as the plain one."""
    gen = torch.Generator(device=dev).manual_seed(splits + rep)
    B, H, S = 4, 1 if rep == 71 else 2, 2048
    q = torch.randn((B, H, rep, d), generator=gen, device=dev).to(torch.bfloat16)
    kv, sc = _decode_cache(gen, dev, quantized, 1, B, H, S, d)
    kv, sc = [t[0] for t in kv], [None if t is None else t[0] for t in sc]
    scale = d ** -0.5
    lengths = torch.tensor([0, 1, 512, 2048], dtype=torch.int32, device=dev)
    for window in (None, 256):
        got = fd.launch_attend(q, *kv, *sc, lengths, scale, window, splits=splits)
        _close(got, fd.plain_attend(q, *kv, *sc, lengths, scale, window))
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    if quantized:
        new = [torch.randint(-127, 128, (B, H, d), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8) for _ in range(2)]
        nsc = [torch.rand((B, H), generator=gen, device=dev) / 50 for _ in range(2)]
    else:
        new = [torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        nsc = [None, None]
    for window in (None, 256):
        ref = [None if t is None else t.clone() for t in kv + sc]
        got = fd.launch(q, *new, *nsc, *kv, *sc, offsets, scale, window, splits=splits)
        want = fd.plain(q, *new, *nsc, *ref, offsets, scale, window)
        _close(got, want)
        assert all(t is None or torch.equal(t, r) for t, r in zip(kv + sc, ref))


def test_gather_wraps_kernel_matches_plain(dev):
    """B16: the warp-shuffle gather at indices 128..255 against the gather at
    idx % 128; the probe answers True on the card (shuffles wrap)."""
    from aqlm_tpu_torch.ops import kernels as k

    tab, idx = k.wrap_probe_inputs(dev)
    before = _build.KERNELS["gather_wraps"].launches
    got = k.gather_wraps_launch(tab, idx)
    assert _build.KERNELS["gather_wraps"].launches == before + 1
    assert torch.equal(got, k.gather_wraps_plain(tab, idx))
    tab2 = torch.randn((8, 128), device=dev)
    idx2 = torch.randint(0, 256, (8, 128), device=dev, dtype=torch.int32)
    assert torch.equal(k.gather_wraps_launch(tab2, idx2), k.gather_wraps_plain(tab2, idx2))
    k._GATHER_WRAPS.pop("cuda", None)
    assert k.gather_wraps() is True


# --------------------------------------------------------------------------- K1's tables and B10's two paths


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
def test_lut_gemv_tables_match_plain(dev, rows, K):
    """K1 (per-block shared-memory tables) at every row count and 1, 2 and 8
    codebooks: fused 128 + 128 (a proj_map; a block per 128-column tile),
    one 256-column projection over 4096 inputs (split input groups), bf16
    and f32 x and output; within one bf16 step of its plain version."""
    gen = torch.Generator(device=dev).manual_seed(rows * 10 + K)
    for sizes, in_f in (((128, 128), 1024), ((256,), 4096)):
        codes, cb, scales = _codes_k(gen, dev, sizes, in_f, K)
        pm = lg.proj_map_for(sizes, codes.shape[-1], dev) if len(sizes) > 1 else None
        x = torch.randn((rows, in_f), generator=gen, device=dev)
        for xt in (x.to(torch.bfloat16), x):
            for out_dtype in (torch.bfloat16, torch.float32):
                before = _build.KERNELS["lut_gemv"].launches
                got = lg.launch(xt, codes[1], cb[1], scales[1], pm, out_dtype, 8,
                                proj_cols=math.gcd(*sizes))
                assert _build.KERNELS["lut_gemv"].launches == before + 1
                assert got.dtype == out_dtype and got.shape == (rows, sum(sizes))
                _close(got, lg.plain(xt, codes[1], cb[1], scales[1], pm, out_dtype))


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("rows", [1, 2, 4, 5, 8])
def test_lut_moe_gemv_tables_match_plain(dev, rows, K):
    """K1's all-expert instance at 1, 2 and 8 codebooks, shared and
    per-expert x, bf16 and f32: f32 out within one bf16 step of the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(rows * 10 + K)
    E, out_f, in_f = 3, 256, 2048
    codes = torch.randint(0, 256, (E, out_f // 128, in_f // 8 * K, 128), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((E, K, 256, 8), generator=gen, device=dev) / (2 * K)).to(torch.bfloat16)
    scales = torch.rand((E, out_f), generator=gen, device=dev) + 0.5
    for per_expert in (False, True):
        x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen, device=dev)
        for xt in (x.to(torch.bfloat16), x):
            before = _build.KERNELS["lut_moe_gemv"].launches
            got = lg.moe_launch(xt, codes, cb, scales, 8)
            assert _build.KERNELS["lut_moe_gemv"].launches == before + 1
            _close(got, lg.moe_plain(xt, codes, cb, scales))


@pytest.mark.parametrize("rows", [1, 3, 4, 8])
def test_lut_gemv_ragged_blocks_match_plain(dev, rows):
    """K1's 512-column blocks cut at a projection's end: fused 1152 + 1152
    (three blocks a projection, the last 128 wide), and the all-expert
    instance at E=8, OUT 2176 (five blocks an expert, the last 128 wide),
    bf16 x; within one bf16 step of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    sizes = (1152, 1152)
    codes, cb, scales = _codes_k(gen, dev, sizes, 512, 2)
    pm = lg.proj_map_for(sizes, codes.shape[-1], dev)
    assert lg.plan(rows, 2, 2304, 64, 128, 2, 1, 132, 1152).blocks_per_proj == 3
    x = torch.randn((rows, 512), generator=gen, device=dev).to(torch.bfloat16)
    got = lg.lut_gemv_kx8_grouped_indexed(x, codes, cb, scales, sizes, 1, group=8)
    _close(got, lg.plain(x, codes[1], cb[1], scales[1], pm, torch.bfloat16))
    E, out_f = 8, 2176
    assert lg.plan(rows, 2, out_f, 64, 128, 1, E).blocks_per_proj == 5
    mcodes = torch.randint(0, 256, (E, out_f // 128, 128, 128), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    mcb = (torch.randn((E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    mscales = torch.rand((E, out_f), generator=gen, device=dev) + 0.5
    mx = torch.randn((rows, 512), generator=gen, device=dev).to(torch.bfloat16)
    _close(lg.moe_launch(mx, mcodes, mcb, mscales, 8), lg.moe_plain(mx, mcodes, mcb, mscales))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 2, 8, 9, 64, 200, 1024])
@pytest.mark.parametrize("out_f,ld", [(200, 1008), (4104, 2064)])
def test_int8_matmul_transposed_paths_at_ragged_edges(dev, out_f, ld, rows, g_dtype):
    """B10's GEMV (<= 8 rows) and GEMM at OUT a multiple of 8 but not of 64
    and IN_pad a multiple of 16 but not of 128, split and unsplit; within one
    bf16 step of its plain version, the same bytes on a second launch."""
    gen = torch.Generator(device=dev).manual_seed(out_f + rows)
    w8 = torch.randint(-127, 128, (out_f, ld), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand(out_f, generator=gen, device=dev) / (127 * out_f ** 0.5)
    g = torch.randn((rows, out_f), generator=gen, device=dev).to(g_dtype)
    before = _build.KERNELS["int8_matmul_transposed"].launches
    got = im.launch_t(g, w8, scale)
    assert _build.KERNELS["int8_matmul_transposed"].launches == before + 1
    assert got.shape == (rows, ld) and got.dtype == torch.bfloat16
    _close(got, im.plain_t(g, w8, scale))
    assert torch.equal(im.launch_t(g, w8, scale), got)


# The int4 GEMV (<= 8 rows) over its plan's branches: activations staged in
# shared memory whole, or in two runs where they do not fit (8 rows of 14336
# columns); an OUT that is not a multiple of 16; every row count.
GEMV4_IN = [4096, 11008, 14336]
GEMV4_OUT = [4096, 200]


def test_int4_gemv_cases_cover_both_plan_branches(dev):
    runs = {i4.plan(rows, o, i, i4.pad_in_features_int4(i) // 2).runs
            for rows in range(1, 9) for o in GEMV4_OUT for i in GEMV4_IN}
    assert runs == {1, 2}


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("in_f", GEMV4_IN)
@pytest.mark.parametrize("out_f", GEMV4_OUT)
def test_int4_gemv_plan_branches_match_plain(dev, out_f, in_f, rows):
    """Within one bf16 step of the plain version, and bit-identical over two
    runs (the warps' sums meet in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(rows + out_f + in_f)
    w4, gs, _ = _int4(gen, dev, 1, out_f=out_f, in_f=in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int4_matmul"].launches
    got = i4.int4_matmul(x, w4[0], gs[0])
    assert _build.KERNELS["int4_matmul"].launches == before + 1
    _close(got, i4.plain(x, w4[0], gs[0]))
    assert torch.equal(got, i4.int4_matmul(x, w4[0], gs[0]))


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("shape", [(3, 200, 4096), (2, 4096, 11008), (8, 4096, 14336)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int4_moe_gemv_plan_branches_match_plain(dev, shape, rows, per_expert):
    """All experts in one launch, the expert a tile coordinate: shared and
    per-expert x (staged again where a block's tiles change expert; in two
    runs at 8 rows of 14336 columns); bit-identical over two runs."""
    E, out_f, in_f = shape
    w4, gs = _int4_moe(E, out_f, in_f)
    gen = torch.Generator(device=dev).manual_seed(rows + E)
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen,
                    device=dev).to(torch.bfloat16)
    got = i4.int4_moe_matmul_indexed(x, w4, gs, 1)
    _close(got, i4.moe_plain(x, w4[1], gs[1]))
    assert torch.equal(got, i4.int4_moe_matmul_indexed(x, w4, gs, 1))


# The int8 GEMV (<= 8 rows) over its plan's branches: one block an SM (OUT
# 4096: 256 tiles), one block a tile where there are fewer tiles than SMs
# (OUT 64 and the ragged OUT 520), the contraction staged whole or in runs
# (Llama's down at 4-8 rows; Mixtral's per-expert down below); every row
# count.
GEMV8_SHAPES = [(4096, 4096), (4096, 11008), (64, 4544), (520, 1040)]


def test_int8_gemv_cases_cover_every_plan_branch(dev):
    sms = _build.sm_count(dev.index)
    blocks = {(p.form, p.blocks == sms, p.runs > 1) for rows in range(1, 9)
              for o, i in GEMV8_SHAPES for p in [im.plan(rows, o, i, im.pad_in_features(i), 1, sms)]}
    assert blocks == {("rows", False, False), ("mma", True, False), ("mma", True, True),
                      ("mma", False, False)}
    assert im.plan(8, 4096, 14336, 14336, 8, sms).runs == 4


@pytest.mark.parametrize("rows", range(1, 9))
@pytest.mark.parametrize("out_f,in_f", GEMV8_SHAPES)
def test_int8_gemv_plan_branches_match_plain(dev, out_f, in_f, rows):
    """Within one bf16 step of the plain version, and bit-identical over two
    runs (the warps' sums meet in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(rows + out_f + in_f)
    w8, scale, _ = _int8(gen, dev, 1, out_f=out_f, in_f=in_f)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.KERNELS["int8_matmul"].launches
    got = im.int8_matmul(x, w8[0], scale[0])
    assert _build.KERNELS["int8_matmul"].launches == before + 1
    _close(got, im.plain(x, w8[0], scale[0]))
    assert torch.equal(got, im.int8_matmul(x, w8[0], scale[0]))


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("rows,runs", [(2, 0), (3, 2), (8, 4)])
def test_int8_moe_gemv_two_runs_match_plain(dev, rows, runs, per_expert):
    """Mixtral-8x7B's all-expert down shape at 2 rows (the row kernel), 3
    (the tensor-core GEMV in two runs, each tile's sums kept between them)
    and 8 (in four), shared and per-expert x (staged anew where a block's
    tiles change expert); bit-identical over two runs."""
    E, out_f, in_f = 8, 4096, 14336
    gen = torch.Generator(device=dev).manual_seed(rows + per_expert)
    w8, scale = _moe(gen, dev, E, out_f, in_f, L=1)
    assert im.plan(rows, out_f, in_f, w8.shape[-1], E, _build.sm_count(dev.index)).runs == runs
    x = torch.randn((E, rows, in_f) if per_expert else (rows, in_f), generator=gen,
                    device=dev).to(torch.bfloat16)
    got = im.int8_moe_matmul(x, w8[0], scale[0])
    _close(got, im.moe_plain(x, w8[0], scale[0]))
    assert torch.equal(got, im.int8_moe_matmul(x, w8[0], scale[0]))


def test_int8_gemv_on_two_streams(dev):
    """GEMV launches on two streams at once (dense and all-expert): each
    equals its plain version and every rerun is bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(5)
    w8, scale, _ = _int8(gen, dev, 1, out_f=4096, in_f=11008)
    mw, ms = _moe(gen, dev, 3, 520, 1040, L=1)
    xs = [torch.randn((4, 11008), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    mx = [torch.randn((3, 5, 1040), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    runs = [lambda i=i: (im.int8_matmul(xs[i], w8[0], scale[0]),
                         im.int8_moe_matmul(mx[i], mw[0], ms[0])) for i in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(runs[i]())
    torch.cuda.synchronize(dev)
    for i, got in enumerate(outs):
        _close(got[0][0], im.plain(xs[i], w8[0], scale[0]))
        _close(got[0][1], im.moe_plain(mx[i], mw[0], ms[0]))
        assert all(torch.equal(g[0], got[0][0]) and torch.equal(g[1], got[0][1]) for g in got)


def test_int8_gemv_allocates_only_its_output_and_makes_no_sync(dev):
    """A decode launch (dense and all-expert) allocates its output and
    nothing else (no partials, no tickets) and issues no synchronising call."""
    gen = torch.Generator(device=dev).manual_seed(6)
    w8, scale, _ = _int8(gen, dev, 1, out_f=4096, in_f=4096)
    mw, ms = _moe(gen, dev, 2, 128, 4096, L=1)
    x = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    for run in (lambda: im.int8_matmul(x, w8[0], scale[0]),
                lambda: im.int8_moe_matmul(x, mw[0], ms[0])):
        first = run()
        torch.cuda.synchronize(dev)
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            second = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs + 1
        assert torch.equal(first, second)


# The int8 split paths that remain (the forward GEMM at short prompts over
# narrow projections, B10's GEMV and GEMM): each launch's last blocks zero
# their tickets again, so launches back to back, and on two streams, share
# their stream's buffer without a memset.
SPLIT8_CASES = [("gemm", 64, 4096, 11008), ("t_gemv", 4, 4096, 4096), ("t_gemm", 200, 4096, 4096)]


def _split8_run(gen, dev, kind, rows, out_f, in_f):
    w8, scale, _ = _int8(gen, dev, 1, out_f=out_f, in_f=in_f)
    sms = _build.sm_count(dev.index)
    if kind == "gemm":
        assert im.plan(rows, out_f, in_f, w8.shape[-1], 1, sms).splits > 1
        x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
        return (lambda: im.int8_matmul(x, w8[0], scale[0])), im.plain(x, w8[0], scale[0])
    p = im.plan_t(rows, out_f, w8.shape[-1], sms)
    assert p.splits > 1 and p.path == kind[2:]
    g = torch.randn((rows, out_f), generator=gen, device=dev).to(torch.bfloat16)
    return (lambda: im.int8_matmul_transposed(g, w8[0], scale[0])), im.plain_t(g, w8[0], scale[0])


@pytest.mark.parametrize("case", SPLIT8_CASES, ids=lambda c: c[0])
def test_int8_split_tickets_reset_themselves(dev, case):
    """Ten launches back to back: every one within a bf16 step of the plain
    version and bit-identical to the first; the stream's tickets are zero
    after each, and no launch issues a synchronising call."""
    gen = torch.Generator(device=dev).manual_seed(7)
    run, want = _split8_run(gen, dev, *case)
    first = run()
    _close(first, want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [run() for _ in range(10)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(o, first) for o in outs)
    assert not _build.tickets(dev, 1).any()


@pytest.mark.parametrize("case", SPLIT8_CASES, ids=lambda c: c[0])
def test_int8_split_tickets_on_two_streams(dev, case):
    """Launches on two streams at once keep their own tickets: each launch
    equals its stream's first and the plain version."""
    gen = torch.Generator(device=dev).manual_seed(8)
    pairs = [_split8_run(gen, dev, *case) for _ in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(pairs[i][0]())
    torch.cuda.synchronize(dev)
    for (_, want), got in zip(pairs, outs):
        _close(got[0], want)
        assert all(torch.equal(g, got[0]) for g in got)


# The int4 prefill GEMM's split path: its last blocks zero their tickets
# again, as the int8 GEMM's do (dense at bm 64 and 128, and all-expert).
SPLIT4_CASES = [("bm64", 64, 4096, 11008, 0), ("bm128", 200, 520, 11008, 0),
                ("moe", 64, 520, 1040, 3)]


def _split4_run(gen, dev, rows, out_f, in_f, experts):
    sms = _build.sm_count(dev.index)
    ldb = i4.pad_in_features_int4(in_f) // 2
    assert i4.plan(rows, out_f, in_f, ldb, max(experts, 1), sms).splits > 1
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    if experts:
        w4, gs = _int4_moe(experts, out_f, in_f, L=1)
        return (lambda: i4.moe_launch(x, w4[0], gs[0])), i4.moe_plain(x, w4[0], gs[0])
    w4, gs, _ = _int4(gen, dev, 1, out_f=out_f, in_f=in_f)
    return (lambda: i4.launch(x, w4[0], gs[0])), i4.plain(x, w4[0], gs[0])


@pytest.mark.parametrize("case", SPLIT4_CASES, ids=lambda c: c[0])
def test_int4_split_tickets_reset_themselves(dev, case):
    """Ten launches back to back: every one within a bf16 step of the plain
    version and bit-identical to the first; the stream's tickets are zero
    after each, and no launch allocates tickets or issues a synchronising
    call."""
    gen = torch.Generator(device=dev).manual_seed(13)
    run, want = _split4_run(gen, dev, *case[1:])
    first = run()
    _close(first, want)
    torch.cuda.synchronize(dev)
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [run() for _ in range(10)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # each launch: its output and its f32 partial sums, no tickets
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == allocs + 20
    assert all(torch.equal(o, first) for o in outs)
    assert not _build.tickets(dev, 1).any()


@pytest.mark.parametrize("case", SPLIT4_CASES, ids=lambda c: c[0])
def test_int4_split_tickets_on_two_streams(dev, case):
    """Launches on two streams at once keep their own tickets: each launch
    equals its stream's first and the plain version."""
    gen = torch.Generator(device=dev).manual_seed(14)
    pairs = [_split4_run(gen, dev, *case[1:]) for _ in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(pairs[i][0]())
    torch.cuda.synchronize(dev)
    for (_, want), got in zip(pairs, outs):
        _close(got[0], want)
        assert all(torch.equal(g, got[0]) for g in got)


def _k3_inputs(gen, dev, quantized, L, B, H, rep, S, d):
    q = torch.randn((B, H, rep, d), generator=gen, device=dev).to(torch.bfloat16)
    kv, sc = _decode_cache(gen, dev, quantized, L, B, H, S, d)
    if quantized:
        new = [torch.randint(-127, 128, (B, H, d), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8) for _ in range(2)]
        nsc = [torch.rand((B, H), generator=gen, device=dev) / 50 for _ in range(2)]
    else:
        new = [torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        nsc = [None, None]
    return q, kv, sc, new, nsc


# K3's row kernel: (B, Hkv, S) grids whose plans take 64-, 128- and 256-key
# splits, several merged by a row's last, and with a window one split a row
K3_ROW_GRIDS = {"small": (4, 2, 512), "mid": (4, 8, 2048), "large": (4, 32, 2048)}
K3_ROW_HEADS = [(1, 128), (2, 128), (4, 128), (8, 128), (1, 64), (8, 64)]


def test_flash_decode_row_cases_cover_every_plan_branch(dev):
    sms = _build.sm_count(dev.index)
    plans = {(p.kps, p.splits > 1) for b, h, s in K3_ROW_GRIDS.values() for rep, d in K3_ROW_HEADS
             for quant in (True, False) for window in (None, 256)
             for p in [fd.row_plan(b, h, rep, d, s, quant, window, sms)]}
    assert plans >= {(64, True), (128, True), (256, True), (256, False)}


@pytest.mark.parametrize("grid", K3_ROW_GRIDS)
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rep,d", K3_ROW_HEADS)
def test_flash_decode_row_kernel_matches_plain(dev, rep, d, quantized, window, grid):
    """K3's row kernel at 1/2/4/8 query heads per kv head, offsets 0, 63, 64
    and S - 1, at grids whose plans take 64-, 128- or 256-key splits (one
    split a row, or several merged by the row's last): one bf16 step of the
    plain version, the written rows and scales equal to the plain version's,
    the output bit-identical over two runs."""
    gen = torch.Generator(device=dev).manual_seed(rep + d + (window or 0))
    B, H, S = K3_ROW_GRIDS[grid]
    L = 2
    offsets = torch.tensor([0, 63, 64, S - 1], dtype=torch.int32, device=dev)
    q, kv, sc, new, nsc = _k3_inputs(gen, dev, quantized, L, B, H, rep, S, d)
    ref = [None if t is None else t[1].clone() for t in kv + sc]
    layer = lambda t: None if t is None else t[1]
    args = (q, new[0], new[1], nsc[0], nsc[1], *[layer(t) for t in kv + sc], offsets, d ** -0.5,
            window)
    got = fd.launch(*args)
    want = fd.plain(q, new[0], new[1], nsc[0], nsc[1], *ref, offsets, d ** -0.5, window)
    _close(got, want)
    for t, r in zip(kv + sc, ref):
        if r is not None:
            assert torch.equal(t[1], r)
    assert torch.equal(got, fd.launch(*args))


def test_flash_decode_row_kernel_on_two_streams(dev):
    """K3 launches on two streams at once, every row merging several splits:
    each stream keeps its own tickets, so each launch equals the plain
    version and every rerun is bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(3)
    L, B, H, rep, S, d = 2, 4, 8, 1, 2048, 128
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    assert fd.row_plan(B, H, rep, d, S, True, None, _build.sm_count(dev.index)).splits > 1
    args, wants = [], []
    for _ in range(2):
        q, kv, sc, new, nsc = _k3_inputs(gen, dev, True, L, B, H, rep, S, d)
        ref = [t[1].clone() for t in kv + sc]
        wants.append(fd.plain(q, new[0], new[1], nsc[0], nsc[1], *ref, offsets, d ** -0.5, None))
        args.append((q, new[0], new[1], nsc[0], nsc[1], *[t[1] for t in kv + sc], offsets,
                     d ** -0.5, None))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(16):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fd.launch(*args[i]))
    torch.cuda.synchronize(dev)
    for got, want in zip(outs, wants):
        _close(got[0], want)
        assert all(torch.equal(g, got[0]) for g in got)


def test_flash_decode_row_kernel_makes_no_sync(dev):
    """A K3 launch whose rows merge several splits issues one kernel and no
    synchronising call (its scratch comes from the allocator, its tickets
    are kept zero by the kernel itself)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, H, rep, S, d = 2, 4, 8, 4, 2048, 128
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, H * rep, d), generator=gen, device=dev).to(torch.bfloat16)
    kv, sc = _decode_cache(gen, dev, True, L, B, H, S, d)
    nk = torch.randint(-127, 128, (B, 1, H, d), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    ns = torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50
    run = lambda: fd.flash_decode_write_attention_indexed(
        q, nk, nk, kv[0], kv[1], sc[0], sc[1], 1, offsets, k_scale_new=ns, v_scale_new=ns)[0]
    first = run()
    assert fd.row_plan(B, H, rep, d, S, True).splits > 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, second)


# --------------------------------------------------------------------------- PV-tuning


def _tiny_pv(dev_or_cpu):
    """A 2-layer reference-mode 2x8 student (hidden 256) and a dense teacher,
    made on the CPU from seeds and moved to ``dev_or_cpu``."""
    from aqlm_tpu_torch.models.quantize import random_quantize_projections
    from aqlm_tpu_torch.pv.trainer import tree_map

    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=512,
                                 num_heads=4, num_kv_heads=4)
    teacher = llama.init_random_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32,
                                       device="cpu")
    student = random_quantize_projections(
        torch.Generator().manual_seed(1),
        llama.init_random_params(torch.Generator().manual_seed(2), cfg, dtype=torch.float32,
                                 device="cpu"), SCHEME_2X8)
    move = lambda p: tree_map(lambda t: None if t is None else t.to(dev_or_cpu), p)
    return cfg, move(teacher), move(student)


def test_tiny_pv_step_matches_the_cpu(dev):
    """One PV grad pass, update and V step of the 2-layer student on the card
    against the CPU (plain versions): loss rtol 1e-4, every trainable and ST
    gradient within 1e-3 of its largest CPU magnitude, codes after the V step
    identical; B13 14 a grad pass (the ST-active projections' dequant) plus
    14 at the buffers' init, B14 14, nothing else."""
    from aqlm_tpu_torch.pv import PVConfig, configurable_adamw, init_pv_state, make_pv_step
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    pv = PVConfig(chunk_tokens=8, code_lr=5e-2, max_code_change_per_step=0.25)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16)))
    out = {}
    for d in (dev, torch.device("cpu")):
        cfg, teacher, student = _tiny_pv(d)
        _build.reset_launch_counts()
        state = init_pv_state(student, configurable_adamw(1e-3, b1=0.9, b2=0.95),
                              configurable_adamw(pv.code_lr, b1=0.9, b2=0.95))
        fns = make_pv_step(cfg, cfg, pv)
        loss, grads = fns.grad_fn(state, teacher, ids.to(d))
        state = fns.code_step(fns.apply_fn(state, grads))
        if d.type == "cuda":
            torch.cuda.synchronize()
        counts = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
        codes = [state.frozen["layers"][li][n].codes.cpu() for li in range(2)
                 for n in llama.QUANTIZABLE_PROJS]
        out[d.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)], codes, counts)
    (loss, grads, codes, counts), (want_loss, want_grads, want_codes, _) = out["cuda"], out["cpu"]
    assert counts == {"dequantize_onehot": 28, "cb_grad_segment": 14}, counts
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for g, w in zip(grads, want_grads):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()) + 1e-30
    assert all(torch.equal(a, b) for a, b in zip(codes, want_codes))


@pytest.mark.parametrize("window", ["list", "stack"])
def test_tiny_scanned_pv_pass_matches_the_cpu(dev, window):
    """One gradient pass of the scanned student ("manual", B13/B14) on the
    card against the CPU's plain versions of the same kernels
    (``scan_dequant="kernel"``), the window at layer 1 as the per-layer list
    or the stack: loss rtol 1e-4, every gradient within 1e-3 of its largest
    CPU magnitude; B13 twice and B14 once a projection a pass (28 and 14),
    plus 7 at the list's init, nothing else."""
    from aqlm_tpu_torch.pv import PVConfig, configurable_adamw, init_pv_state, make_pv_step
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16)))
    out = {}
    for d, impl in ((dev, "auto"), (torch.device("cpu"), "kernel")):
        cfg, teacher, student = _tiny_pv(d)
        _build.reset_launch_counts()
        state = init_pv_state(student, configurable_adamw(1e-3), None, active_layers=(1,))
        args = ()
        if window == "stack":
            state.st_buffers = {k: v.detach()[None] for k, v in state.st_buffers[1].items()}
            args = (None, 1)
        pv = PVConfig(chunk_tokens=8, scan_blocks=True, scan_dequant=impl)
        loss, grads = make_pv_step(cfg, cfg, pv).grad_fn(state, teacher, ids.to(d), *args)
        if d.type == "cuda":
            torch.cuda.synchronize()
        counts = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
        out[d.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)], counts)
    (loss, grads, counts), (want_loss, want_grads, _) = out["cuda"], out["cpu"]
    assert counts == {"dequantize_onehot": 35, "cb_grad_segment": 14}, counts
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for g, w in zip(grads, want_grads):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()) + 1e-30


# --------------------------------------------------------------------------- speculative decoding


def _spec_engine(dev, draft_layers):
    """A 2-layer 2x8 codes Llama (hidden 256, well-scaled draw) and its
    speculative Engine, drafted by its first ``draft_layers`` layers with the
    same embedding, final norm and head; max_len 128, so the draft's steps
    take K3."""
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=256,
                                 num_heads=4, num_kv_heads=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     weight_scale=1.0)
    dcfg = dataclasses.replace(cfg, num_layers=draft_layers)
    draft = {**params, "layers": params["layers"][:draft_layers]}
    engine = Engine(params, cfg, ServeConfig(max_batch=4, max_len=128, prefill_buckets=(16, 64)),
                    draft_params=draft, draft_cfg=dcfg, spec_k=3)
    return cfg, params, engine


@pytest.mark.parametrize("draft_layers", [2, 1])
def test_spec_engine_on_the_card_is_exact_within_tolerance(dev, draft_layers):
    """Greedy answers of the speculative Engine (self-draft and a 1-layer
    draft) against one teacher-forced ``forward_stacked`` of the target over
    prompt + answer: every emitted token's logit within 3e-2 max|logit| of
    its position's largest; K1, K2 and K3 launched, nothing else; the
    self-draft accepts at least 90% of its proposals."""
    from aqlm_tpu_torch.models.stacked import forward_stacked

    cfg, params, engine = _spec_engine(dev, draft_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 17, 40, 9)]
    _build.reset_launch_counts()
    out = engine.generate(prompts, SamplingParams(max_new_tokens=12))
    counts = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
    assert sorted(counts) == sorted(CODES_KERNELS), counts
    assert [len(o) for o in out] == [12] * 4
    for p, o in zip(prompts, out):
        ids = torch.as_tensor(np.concatenate([p, o]), device=dev)[None]
        logits = forward_stacked(engine.params, cfg, ids)[0][0, len(p) - 1:-1].float()
        got = logits.gather(-1, torch.as_tensor(o, device=dev)[:, None])[:, 0]
        gap = float((logits.max(-1).values - got).max())
        assert gap <= 3e-2 * float(logits.abs().max()), gap
    st = engine.spec_stats
    assert st["proposed"] > 0 and (draft_layers == 1 or st["accepted"] >= 0.9 * st["proposed"])


def test_spec_round_makes_no_sync(dev):
    """A round (k+1 draft forwards, the verify, the accept) issues no
    synchronising call, greedy or with a sampled row; the step reads back
    once after it."""
    cfg, _, engine = _spec_engine(dev, 1)
    inner = engine._spec_round

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    engine._spec_round = strict
    rng = np.random.default_rng(1)
    engine.submit(rng.integers(0, cfg.vocab_size, 20), SamplingParams(max_new_tokens=10))
    engine.submit(rng.integers(0, cfg.vocab_size, 30),
                  SamplingParams(max_new_tokens=10, temperature=0.8, top_p=0.9))
    while engine._pending or engine._active:
        engine.step()
    assert engine.spec_stats["proposed"] > 0
