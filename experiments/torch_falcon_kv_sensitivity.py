"""How far a 2-layer full-width model's logits move when only the summation
order of its projections changes, with an int8 or a bf16 KV cache.

    python3 experiments/torch_falcon_kv_sensitivity.py {falcon,llama} {int8,bf16}

Runs on the CPU, with the port's plain versions: a model and a prompt built
as ``chip_smoke.py``'s reference phase builds them (random 2x8 codes from
seed 1, here of the CPU's generator; 20 prefill tokens, then 3 decode steps,
max_len 256), once as it is and once with every f32 matrix product of
IN >= 1024 summed in two parts (another order of the same sums). Prints the largest logit difference over the
largest logit, and per position. No kernel runs: what moves is rounding
alone (bf16 outputs, int8 KV quantization) amplified by the model.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from aqlm_tpu_torch.config import SCHEME_2X8  # noqa: E402
from aqlm_tpu_torch.models import falcon, llama  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache  # noqa: E402
from aqlm_tpu_torch.serve import ServeConfig  # noqa: E402
from aqlm_tpu_torch.serve.engine import serving_params  # noqa: E402

model, kv = sys.argv[1], sys.argv[2]
cfg = falcon.FalconConfig.falcon_7b() if model == "falcon" else llama.ModelConfig.llama2_7b()
cfg2 = dataclasses.replace(cfg, num_layers=2)
params = random_quantized_params(torch.Generator().manual_seed(1), cfg2, SCHEME_2X8, device="cpu")
st = serving_params(params, cfg2, ServeConfig())
ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 23)))


def logits():
    cache = init_kv_cache(cfg2, 1, 256, quantized=kv == "int8", device="cpu")
    out = []
    with torch.inference_mode():
        lg, _ = forward_stacked(st, cfg2, ids[:, :20], cache=cache, cache_offset=0)
        out.append(lg[0, -1])
        for p in range(20, 23):
            lg, _ = forward_stacked(st, cfg2, ids[:, p:p + 1], cache=cache, cache_offset=p)
            out.append(lg[0, -1])
    return torch.stack(out).float()


matmul = torch.matmul


def split_matmul(a, b):
    if a.dim() == 2 and b.dim() == 2 and a.dtype == torch.float32 and a.shape[1] >= 1024:
        h = a.shape[1] // 2 + 8
        return matmul(a[:, :h], b[:h]) + matmul(a[:, h:], b[h:])
    return matmul(a, b)


base = logits()
torch.matmul = split_matmul
moved = logits()
torch.matmul = matmul
err = (base - moved).abs()
print(model, kv, "max|diff| / max|logit|", float(err.max() / base.abs().max()),
      "per position", [round(float(v), 4) for v in err.amax(-1) / base.abs().amax(-1)],
      "argmax agree", float((base.argmax(-1) == moved.argmax(-1)).float().mean()))
