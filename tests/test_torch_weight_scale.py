"""``weight_scale`` of the port's random draws (``random_aqlm_weight``,
``random_quantized_params``) on the CPU: None is the plain draw bit for bit
(its numbers taken here in the draw's own order), and a given scale brings
each quantized projection's dequantized std to ``weight_scale *
in_features^-0.5`` (within 3% at these sizes) from the same codes and
codebooks."""

import pytest
import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.quantize import random_quantized_params
from aqlm_tpu_torch.ops.dequant import dequantize_weight, random_aqlm_weight


@pytest.mark.parametrize("scheme", ["2x8g8", "1x16g8", "1x8g8"])
def test_none_is_the_plain_draw(scheme):
    sc = AqlmScheme.parse(scheme)
    w = random_aqlm_weight(torch.Generator().manual_seed(3), sc, 256, 512, device="cpu")
    gen = torch.Generator().manual_seed(3)
    codes = torch.randint(0, sc.codebook_size, sc.codes_shape(256, 512), generator=gen,
                          dtype=torch.int32).to(sc.code_dtype)
    books = torch.randn(sc.codebooks_shape(), generator=gen) / (sc.num_codebooks
                                                                 * sc.group_numel) ** 0.5
    scales = torch.rand((256 // sc.out_group_size,), generator=gen) + 0.5
    assert torch.equal(w.codes, codes) and torch.equal(w.codebooks, books)
    assert torch.equal(w.scales, scales) and w.bias is None


@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("scheme", ["2x8g8", "1x16g8"])
def test_a_scale_sets_the_std(scheme, scale):
    sc = AqlmScheme.parse(scheme)
    plain = random_aqlm_weight(torch.Generator().manual_seed(4), sc, 512, 2048, device="cpu")
    w = random_aqlm_weight(torch.Generator().manual_seed(4), sc, 512, 2048, device="cpu",
                           weight_scale=scale)
    assert torch.equal(w.codes, plain.codes) and torch.equal(w.codebooks, plain.codebooks)
    std = float(dequantize_weight(w, dtype=torch.float32).std())
    assert abs(std / (scale * 2048 ** -0.5) - 1) < 0.03


def test_random_quantized_params_weight_scale():
    cfg = llama.ModelConfig.tiny(num_layers=2, hidden_size=256, intermediate_size=512)
    sc = AqlmScheme.parse("2x8g8")
    plain = random_quantized_params(torch.Generator().manual_seed(0), cfg, sc, mode="reference",
                                    device="cpu")
    again = random_quantized_params(torch.Generator().manual_seed(0), cfg, sc, mode="reference",
                                    device="cpu", weight_scale=None)
    scaled = random_quantized_params(torch.Generator().manual_seed(0), cfg, sc, mode="reference",
                                     device="cpu", weight_scale=0.5)
    assert torch.equal(scaled["embed"], plain["embed"])
    for l0, l1, l2 in zip(plain["layers"], again["layers"], scaled["layers"]):
        for name, q in l0.items():
            if not hasattr(q, "codes"):
                assert torch.equal(q, l1[name]) and torch.equal(q, l2[name])
                continue
            assert torch.equal(q.scales, l1[name].scales) and torch.equal(q.codes, l2[name].codes)
            w = dequantize_weight(l2[name], dtype=torch.float32)
            assert abs(float(w.std()) / (0.5 * w.shape[1] ** -0.5) - 1) < 0.05, name
