"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the kernels have
no CPU mode). Run them on a machine with the card (``--noconftest``: the
suite's conftest imports JAX, which the port does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance on bf16 outputs: one bf16 step of the plain result plus 1e-3 of its
largest magnitude (both round an f32 sum taken in another order)."""

import numpy as np
import pytest
import torch

from aqlm_tpu_torch.config import SCHEME_2X8
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops import lut_gemv as lg
from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

CODES_KERNELS = ("lut_gemv", "gather_prefill", "flash_decode_write")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    g, w = got.float(), want.float()
    tol = 2.0 ** -7 * w.abs() + 1e-3 * w.abs().max()
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
