#!/usr/bin/env python3
"""Where the stacked forward's K3 decode (the fused KV write + flash decode)
and its plain attention part, on one NVIDIA GPU: Llama-2-7B in 2x8 codes cut
to 2 layers, random weights from seed 5, batch 4, a 64-token prefill and 8
single-token steps. Compares the last step's logits of ``forward_stacked``
(unfused) with ``use_flash_decode`` True and False, over a bf16 and an int8
cache of 128 rows, on the card and on the CPU (the plain versions), and the
unstacked ``llama.forward`` over a bf16 cache of 72 and 128 rows. Prints
max|a - b| / max|b| and the rows whose argmax agrees; writes
chiprun_out/flash_vs_plain.json.

    python3 experiments/torch_flash_vs_plain_probe.py      # from the root of a checkout
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

B, T0, STEPS, LAYERS = 4, 64, 8, 2


def _to(node, dev):
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _to(getattr(node, f.name), dev) for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    return node


def stacked_steps(st, cfg, ids, max_len, quantized, flash):
    cache = stacked.init_kv_cache(cfg, B, max_len, quantized=quantized, device=ids.device)
    stacked.forward_stacked(st, cfg, ids[:, :T0], cache=cache, cache_offset=0,
                            use_flash_decode=flash)
    outs = []
    for p in range(T0, T0 + STEPS):
        out, _ = stacked.forward_stacked(st, cfg, ids[:, p:p + 1], cache=cache, cache_offset=p,
                                         use_flash_decode=flash)
        outs.append(out[:, -1].float().cpu())
    return torch.stack(outs, 1)  # [B, STEPS, V]


def unstacked_steps(params, cfg, ids, max_len):
    cache = llama.init_kv_cache(cfg, B, max_len, device=ids.device)
    llama.forward(params, cfg, ids[:, :T0], kv_caches=cache, cache_offset=0)
    outs = []
    for p in range(T0, T0 + STEPS):
        out, cache = llama.forward(params, cfg, ids[:, p:p + 1], kv_caches=cache, cache_offset=p)
        outs.append(out[:, -1].float().cpu())
    return torch.stack(outs, 1)


def diff(a, b):
    err = (a - b).abs().amax(dim=(0, 2))  # per step
    scale = b.abs().max()
    return {"max_rel_err_by_step": [float(e / scale) for e in err],
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = dataclasses.replace(llama.ModelConfig.llama2_7b(), num_layers=LAYERS)
    dev = torch.device("cuda")
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(5), cfg,
                                     AqlmScheme.parse("2x8g8"), mode="codes", device=dev)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T0 + STEPS)))
    res = {}
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            p = _to(params, d)
            st = serving_params(p, cfg, ServeConfig(max_batch=B, max_len=128,
                                                    fuse_projections=False))
            x = ids.to(d)
            for quant in (False, True):
                for flash in (True, False):
                    res[d.type, "int8" if quant else "bf16", flash] = stacked_steps(
                        st, cfg, x, 128, quant, flash)
            for max_len in (72, 128):
                res[d.type, "unstacked", max_len] = unstacked_steps(p, cfg, x, max_len)
    out = {"nvidia_smi": smi, "layers": LAYERS}
    pairs = {
        "card bf16: flash vs plain": (("cuda", "bf16", True), ("cuda", "bf16", False)),
        "card int8: flash vs plain": (("cuda", "int8", True), ("cuda", "int8", False)),
        "cpu bf16: flash vs plain": (("cpu", "bf16", True), ("cpu", "bf16", False)),
        "cpu int8: flash vs plain": (("cpu", "int8", True), ("cpu", "int8", False)),
        "bf16 flash: card vs cpu": (("cuda", "bf16", True), ("cpu", "bf16", True)),
        "bf16 plain: card vs cpu": (("cuda", "bf16", False), ("cpu", "bf16", False)),
        "int8 flash: card vs cpu": (("cuda", "int8", True), ("cpu", "int8", True)),
        "card unstacked 128 vs 72": (("cuda", "unstacked", 128), ("cuda", "unstacked", 72)),
        "card unstacked 128 vs stacked bf16 plain": (("cuda", "unstacked", 128),
                                                     ("cuda", "bf16", False)),
        "card unstacked 128 vs stacked bf16 flash": (("cuda", "unstacked", 128),
                                                     ("cuda", "bf16", True)),
        "cpu unstacked 128 vs stacked bf16 flash": (("cpu", "unstacked", 128),
                                                    ("cpu", "bf16", True)),
        "unstacked 128: card vs cpu": (("cuda", "unstacked", 128), ("cpu", "unstacked", 128)),
    }
    for name, (a, b) in pairs.items():
        out[name] = diff(res[a], res[b])
        print(name, json.dumps(out[name]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_vs_plain.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
