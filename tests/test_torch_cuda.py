"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (the kernels have
no CPU mode). Run them on a machine with the card (``--noconftest``: the
suite's conftest imports JAX, which the port does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance on bf16 outputs: one bf16 step of the plain result plus 1e-3 of its
largest magnitude (both round an f32 sum taken in another order); two steps
for B15 (``onehot_matmul``), which rounds twice, the product and then the
scaled product, as the TPU kernel does."""

import functools

import numpy as np
import pytest
import torch

from aqlm_tpu_torch.config import SCHEME_2X8
from aqlm_tpu_torch.models import llama, mixtral
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops import flash_decode as fd
from aqlm_tpu_torch.ops import gather_prefill as gp
from aqlm_tpu_torch.ops import int4_matmul as i4
from aqlm_tpu_torch.ops import int8_matmul as im
from aqlm_tpu_torch.ops import kernels as k15
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
    """Query heads per kv head outside 1/2/4/8 run in chunks of 8 (71: nine,
    the last one 7 wide), each block taking the new row in register and chunk
    0 writing it: the output and the written cache match the plain version."""
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
