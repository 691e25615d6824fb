#!/usr/bin/env python3
"""How far the unstacked ``llama.forward`` (K/V into ``llama.init_kv_cache``,
K2 and K1 by their unindexed forms) and the Engine's ``forward_stacked``
(layer-indexed kernels, q/k/v and gate/up fused or not) drift apart with
depth, on one NVIDIA GPU: Llama-2-7B in 2x8 codes, random weights from seed
5, batch 4, a 64-token prefill and 8 cached single-token steps, cut to 2, 4,
8, 16 and 32 layers. Prints, per depth, max|a - b| / max|b| of the last
step's logits and the rows whose argmax agrees, for unstacked against
stacked-fused, unstacked against stacked-unfused, and fused against
unfused; a bf16 cache of 72 rows (the plain attention) and of 128 (K3 in the
stacked form). Writes chiprun_out/unstacked_depth.json.

    python3 experiments/torch_unstacked_depth.py      # from the root of a checkout
"""

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aqlm_tpu_torch.config import AqlmScheme  # noqa: E402
from aqlm_tpu_torch.models import llama, stacked  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.serve import ServeConfig  # noqa: E402
from aqlm_tpu_torch.serve.engine import serving_params  # noqa: E402

B, T0, STEPS = 4, 64, 8


def unstacked_last(params, cfg, ids, max_len):
    cache = llama.init_kv_cache(cfg, B, max_len, device=ids.device)
    llama.forward(params, cfg, ids[:, :T0], kv_caches=cache, cache_offset=0)
    for p in range(T0, T0 + STEPS):
        out, cache = llama.forward(params, cfg, ids[:, p:p + 1], kv_caches=cache, cache_offset=p)
    return out[:, -1].float().cpu()


def stacked_last(params, cfg, ids, max_len, fuse):
    st = serving_params(params, cfg, ServeConfig(max_batch=B, max_len=max_len,
                                                 fuse_projections=fuse))
    cache = stacked.init_kv_cache(cfg, B, max_len, quantized=False, device=ids.device)
    stacked.forward_stacked(st, cfg, ids[:, :T0], cache=cache, cache_offset=0)
    for p in range(T0, T0 + STEPS):
        out, _ = stacked.forward_stacked(st, cfg, ids[:, p:p + 1], cache=cache, cache_offset=p)
    return out[:, -1].float().cpu()


def diff(a, b):
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    return {"max_rel_err": err / scale, "max_abs_err": err,
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = llama.ModelConfig.llama2_7b()
    full = random_quantized_params(torch.Generator(device=dev).manual_seed(5), cfg,
                                   AqlmScheme.parse("2x8g8"), mode="codes", device=dev)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T0 + STEPS)))
    ids = ids.to(dev)
    out = []
    with torch.inference_mode():
        for layers in (2, 4, 8, 16, 32):
            c = dataclasses.replace(cfg, num_layers=layers)
            p = {**full, "layers": full["layers"][:layers]}
            for max_len in (72, 128):
                u = unstacked_last(p, c, ids, max_len)
                f = stacked_last(p, c, ids, max_len, True)
                n = stacked_last(p, c, ids, max_len, False)
                rec = {"layers": layers, "max_len": max_len, "unstacked_vs_fused": diff(u, f),
                       "unstacked_vs_unfused": diff(u, n), "fused_vs_unfused": diff(f, n),
                       "logit_absmax": float(u.abs().max())}
                out.append(rec)
                print(json.dumps(rec), flush=True)
                torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "unstacked_depth.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "records": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
