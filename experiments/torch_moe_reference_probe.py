"""Where the 2-layer Mixtral reference's logit error comes from: routing.

    python3 experiments/torch_moe_reference_probe.py   # from the root of a checkout, one CUDA card

Builds chip_smoke's 2-layer full-width Mixtral-8x7B reference (seed 1, 20
prefill tokens and 3 decode steps, int8 KV cache, max_len 1024) in int8 and
in int4 mode and runs it three times: with the kernels on the card, with
the plain versions on the CPU, and on the CPU again with the routing
weights that the card computed put in place of the CPU's own. For each mode
it prints one JSON line: the logit error of the free CPU run and of the
replayed one against the card (as a share of max|logit|, chip_smoke's
measure), how many (layer, token) routings picked another set of experts on
the two sides, and for those the gap between the k-th and the (k+1)-th
routing probability on the CPU.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

from aqlm_tpu_torch.config import SCHEME_2X8  # noqa: E402
from aqlm_tpu_torch.models import mixtral  # noqa: E402
from aqlm_tpu_torch.models.common import apply_linear  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache  # noqa: E402
from aqlm_tpu_torch.serve import ServeConfig  # noqa: E402
from aqlm_tpu_torch.serve.engine import serving_params  # noqa: E402
from chip_smoke import _to  # noqa: E402

routing = mixtral._routing
dev = torch.device("cuda")
cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(), num_layers=2)
ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 23))


def run(params, d, serve, replay=None):
    """Prefill then 3 decode steps on device ``d``: (last-position logits
    [4, V] f32, the (routing weights, router probabilities) of every layer
    call, on the CPU)."""
    seen = []

    def recorded(xn, layer, c):
        probs = torch.softmax(apply_linear(xn, layer["moe_gate"]).float(), dim=-1)
        w = routing(xn, layer, c) if replay is None else replay[len(seen)][0].to(xn.device)
        seen.append((w.cpu(), probs.cpu()))
        return w

    mixtral._routing = recorded
    st = serving_params(_to(params, d), cfg, serve)
    cache = init_kv_cache(cfg, 1, 1024, quantized=True, device=d)
    logits = []
    with torch.inference_mode():
        x = torch.from_numpy(ids).to(d)
        lg, _ = forward_stacked(st, cfg, x[:, :20], cache=cache, cache_offset=0)
        logits.append(lg[0, -1])
        for p in range(20, 23):
            lg, _ = forward_stacked(st, cfg, x[:, p:p + 1], cache=cache, cache_offset=p)
            logits.append(lg[0, -1])
    mixtral._routing = routing
    return torch.stack(logits).float().cpu(), seen


for mode in ("int8", "int4"):
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(1), cfg, SCHEME_2X8,
                                     mode=mode, device=dev)
    serve = ServeConfig(lm_head_int8=mode == "int8")
    card, card_w = run(params, dev, serve)
    cpu, cpu_w = run(params, torch.device("cpu"), serve)
    replayed, _ = run(params, torch.device("cpu"), serve, replay=card_w)
    scale = cpu.abs().max().item()
    flips, gaps = 0, []
    for (a, _), (b, probs) in zip(card_w, cpu_w):
        differ = ((a > 0) != (b > 0)).any(-1).reshape(-1)
        flips += int(differ.sum())
        # the CPU's own margin at the k-th expert, where the sides disagree
        top = torch.sort(probs.reshape(-1, probs.shape[-1]), dim=-1, descending=True).values
        k = cfg.num_experts_per_tok
        gaps += (top[differ, k - 1] - top[differ, k]).tolist()
    print(json.dumps({
        "mode": mode, "max_abs_logit": scale,
        "rel_err_free": (card - cpu).abs().max().item() / scale,
        "rel_err_card_routing": (card - replayed).abs().max().item() / scale,
        "routings": sum(w[..., 0].numel() for w, _ in cpu_w), "routings_differing": flips,
        "gaps_where_differing": gaps,
    }), flush=True)
    del params
    torch.cuda.empty_cache()
