"""How far a 2-layer full-width model's LoRA gradients move when only the
precision of its activations changes (bf16 against f32 params).

    python3 experiments/torch_lora_grad_sensitivity.py {codes,int8} BATCH SEQ

Runs on the CPU, with the port's plain versions: the params and adapters of
``chip_smoke.py``'s training reference (random 2x8 codes from seed 2,
adapters on q/k/v/o from seed 3, lora_b normal * 0.01), one
``make_lora_step`` on BATCH x SEQ random ids, once with bf16 and once with
f32 embedding, norms and head (so every activation is f32). Prints both
losses and, per adapter, max|grad| and max|bf16 - f32| over max|f32|. No
kernel runs: what moves is rounding alone, amplified by the model. At
SEQ 2 only position 0 enters the loss, and its attention has one key; at
longer SEQ the random weights make attention near one-hot, and a near tie
flips with one rounding.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from aqlm_tpu_torch.config import SCHEME_2X8  # noqa: E402
from aqlm_tpu_torch.models.llama import ModelConfig  # noqa: E402
from aqlm_tpu_torch.models.quantize import random_quantized_params  # noqa: E402
from aqlm_tpu_torch.pv import init_lora_state, make_lora_step  # noqa: E402
from aqlm_tpu_torch.pv.trainer import tree_leaves  # noqa: E402

mode, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(ModelConfig.llama2_7b(), num_layers=2)
ids = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (batch, seq)))
grads = {}
for dtype in (torch.bfloat16, torch.float32):
    params = random_quantized_params(torch.Generator().manual_seed(2), cfg, SCHEME_2X8, mode=mode,
                                     dtype=dtype, device="cpu")
    params = chip_smoke.lora_wrap(params, cfg, torch.Generator().manual_seed(3), b_std=0.01)
    state = init_lora_state(params, lambda p: torch.optim.Adam(p, lr=3e-3))
    state, loss = make_lora_step(cfg)(state, ids)
    grads[dtype] = [t.grad.float() for t in tree_leaves(state.adapters)]
    print(f"{dtype}: loss {float(loss):.6f}")
names = [f"layer{li}.{n}.{f}" for li in range(2) for n in chip_smoke.LORA_TARGETS
         for f in ("lora_a", "lora_b")]
for name, a, b in zip(names, grads[torch.bfloat16], grads[torch.float32]):
    ref = float(b.abs().max())
    rel = float((a - b).abs().max()) / ref if ref else 0.0
    print(f"{name}: max|grad| bf16 {float(a.abs().max()):.3e} f32 {ref:.3e}, "
          f"max|bf16 - f32| / max|f32| {rel:.4f}")
