#!/usr/bin/env python3
"""How peaked the attention of the random 2x8 Llama-2-7B is (the model
``chip_smoke.py`` and the experiments build from a seed), on the CPU:
the dequantized q_proj weight's standard deviation, and at layer 0 over 64
random ids the std of q and of the attention logits q.k / sqrt(d). With
random codebooks (normal / sqrt(K * g)) and scales in [0.5, 1.5) the
weights are ~20x a trained model's, so the softmax is close to an argmax
and two routes that round differently (a fused and an unfused projection,
flash decode and the plain attention) can pick different keys.

    python3 experiments/torch_random_model_scale.py      # from the root of a checkout
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aqlm_tpu_torch.config import AqlmScheme  # noqa: E402
from aqlm_tpu_torch.models import llama  # noqa: E402
from aqlm_tpu_torch.models.common import apply_linear, rms_norm, rope  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.ops.lut_gemv import dequant_tiled_t  # noqa: E402


def main() -> int:
    cfg = dataclasses.replace(llama.ModelConfig.llama2_7b(), num_layers=1)
    p = random_quantized_params(torch.Generator().manual_seed(5), cfg, AqlmScheme.parse("2x8g8"),
                                mode="codes", dtype=torch.float32, device="cpu")
    t = 64
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, t)))
    d = cfg.dim_per_head
    with torch.inference_mode():
        layer = p["layers"][0]
        xn = rms_norm(p["embed"][ids], layer["input_norm"], cfg.rms_eps)
        q = apply_linear(xn, layer["q_proj"]).reshape(1, t, cfg.num_heads, d)
        k = apply_linear(xn, layer["k_proj"]).reshape(1, t, cfg.num_kv_heads, d)
        q, k = rope(q, k, torch.arange(t)[None], cfg.rope_theta)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
        w = layer["q_proj"]
        wstd = dequant_tiled_t(w.codes_tl, w.codebooks[None], None).std()
    print(json.dumps({"q_proj_weight_std": float(wstd), "q_std": float(q.std()),
                      "attention_logit_std": float(logits.std())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
