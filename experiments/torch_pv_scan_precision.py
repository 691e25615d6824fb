#!/usr/bin/env python3
"""How far apart the scanned and the unrolled PV student's gradients lie in
bf16 and in f32, on the CPU (plain versions), at a small width.

The student is ``random_quantized_params``' 2x8 g8 draw at 8 layers (as
chip_smoke.py's ``pv_scan_depth``, narrower), a one-layer zeros ST window at
layer 0, the teacher as hidden states and a dense head, the chunked KL.
Each configuration's loss and its window's and codebooks' gradients are
compared (loss relative error, max|a - b| / max|b|): scanned against
unrolled in bf16 and in f32, and each bf16 path against f32. Then the same
with every projection's scales times in_features^-0.5 / 0.354 (the draw's
weights at a dense layer's scale). Prints one JSON line.

    python3 experiments/torch_pv_scan_precision.py [WIDTH]      # default 256
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from aqlm_tpu_torch.config import AqlmScheme  # noqa: E402
from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS, ModelConfig  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.pv import PVConfig, init_pv_state, make_pv_step  # noqa: E402

LAYERS, TOKENS = 8, 64


def grad_pass(cfg, dtype, scanned, well_scaled):
    params = random_quantized_params(torch.Generator().manual_seed(11), cfg,
                                     AqlmScheme.parse("2x8g8"), mode="reference", dtype=dtype,
                                     device="cpu")
    if well_scaled:
        for layer in params["layers"]:
            for name in QUANTIZABLE_PROJS:
                q = layer[name]
                q.scales.mul_((q.codes.shape[1] * 8) ** -0.5 / 0.354)
    gen = torch.Generator().manual_seed(12)
    h = cfg.hidden_size
    teacher = {"hidden": torch.randn((1, TOKENS, h), generator=gen).to(dtype),
               "head": (torch.randn((cfg.vocab_size, h), generator=gen) * h ** -0.5).to(dtype),
               "embed": None}
    ids = torch.randint(0, cfg.vocab_size, (1, TOKENS), generator=gen)
    state = init_pv_state(params, lambda leaves: None, None, active_layers=())
    zeros = {n: torch.zeros((1, q.codes.shape[0], q.codes.shape[1] * 8))
             for n, q in ((n, params["layers"][0][n]) for n in QUANTIZABLE_PROJS)}
    state.st_buffers = zeros if scanned else [{k: v[0] for k, v in zeros.items()}] + [
        {} for _ in range(LAYERS - 1)]
    fns = make_pv_step(cfg, cfg, PVConfig(chunk_tokens=256, scan_blocks=scanned),
                       teacher_kind="hidden")
    loss, (g_tr, g_st) = fns.grad_fn(state, teacher, ids, *((None, 0) if scanned else ()))
    window = g_st if scanned else {k: v[None] for k, v in g_st[0].items()}
    books = [{n: g_tr["layers"][li][n].codebooks.float() for n in QUANTIZABLE_PROJS}
             for li in range(LAYERS)]
    return float(loss), window, books


def gaps(a, b):
    (la, wa, ca), (lb, wb, cb) = a, b
    return {"loss_rel_err": abs(la - lb) / abs(lb),
            "window_grad_err_over_max": max(float((wa[k] - wb[k]).abs().max()
                                                  / wb[k].abs().max()) for k in wb),
            "codebook_grad_err_over_max": max(float((x[n] - y[n]).abs().max() / y[n].abs().max())
                                              for x, y in zip(ca, cb) for n in y)}


def main() -> None:
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    cfg = ModelConfig(num_layers=LAYERS, vocab_size=256, hidden_size=width,
                      intermediate_size=2 * width, num_heads=4, num_kv_heads=4)
    out = {"width": width, "layers": LAYERS, "tokens": TOKENS}
    for label, well_scaled in (("random_quantized_params", False), ("well_scaled", True)):
        r = {(dt, sc): grad_pass(cfg, dt, sc, well_scaled)
             for dt in (torch.bfloat16, torch.float32) for sc in (True, False)}
        bf, f = torch.bfloat16, torch.float32
        out[label] = {"bf16_scan_vs_unrolled": gaps(r[(bf, True)], r[(bf, False)]),
                      "f32_scan_vs_unrolled": gaps(r[(f, True)], r[(f, False)]),
                      "bf16_scan_vs_f32": gaps(r[(bf, True)], r[(f, True)]),
                      "bf16_unrolled_vs_f32": gaps(r[(bf, False)], r[(f, True)])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
