"""The port's LoRA trainer (``pv.lora.make_lora_step``, ``torch.optim.Adam``)
against aqlm_tpu's (``optax.adam``: the same update) on the CPU.

``ModelConfig.tiny(hidden_size=128, intermediate_size=256)``, 2 layers, 2x8
codes, int8 and reference mode, bf16 params (the flow as users run it) and
f32 params; JAX's random model with adapters on q/k/v/o (r 4, lora_a normal
/ sqrt(r), lora_b zeros, wrapped through ``map_quantized_linears``, as a user
wraps serving layouts that ``attach_lora`` refuses) carried across by
``convert``; 4 steps of Adam(3e-3) on one batch of 2 x 16 ids; JAX's
serving matmuls run their Pallas kernels in interpret mode, the port's the
plain versions (B10, B5/B13 in the backward).

Tolerances, and why: both packages compute the same function with sums in
other orders, so bf16 roundings (the activations, and the serving backward's
bf16 cotangent) land on neighbouring values here and there.

- First step: the loss within rtol 1e-3 (measured <= 3.6e-4). Adam's first
  update is about lr * sign(gradient) for every element, so a gradient near
  zero may step the other way: at least 97% of lora_b's elements agree
  within 1e-4 (measured 98.7%), the others are +-lr apart.
- Four steps: those flips grow through Adam's normalised updates, so the
  losses agree within rtol 2.5e-2 at bf16 (measured <= 1.2e-2) and 5e-3 in
  the f32 serving modes (<= 1.3e-3), and the adapters elementwise within
  8 lr (each side moves an element about lr a step; measured <= 0.020).
  Reference mode in f32 has no bf16 rounding on the path: losses within
  rtol 1e-5 and adapters within 5e-5 (measured 1.7e-6 and 1.3e-5).
- The loss falls on both sides, as JAX's own LoRA test requires.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import f32, to_numpy_tree

from aqlm_tpu.config import AqlmScheme as JScheme
from aqlm_tpu.models import llama as jllama
from aqlm_tpu.models.common import LoraLinear as JLoraLinear
from aqlm_tpu.models.quantize import map_quantized_linears as j_map_quantized_linears
from aqlm_tpu.models.quantize import random_quantized_params as j_random_quantized_params
from aqlm_tpu.pv import lora as jlora
from aqlm_tpu_torch.convert import params_from_numpy
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import LoraLinear
from aqlm_tpu_torch.pv import init_lora_state, make_lora_step, merge_trainable

TINY = dict(num_layers=2, hidden_size=128, intermediate_size=256)
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
LR, STEPS = 3e-3, 4


def lora_pair(mode, dtype, r=4):
    """JAX's tiny model with adapters on ``TARGETS``, and the same tree in the port."""
    cfg = jllama.ModelConfig.tiny(**TINY)
    jp = j_random_quantized_params(jax.random.PRNGKey(0), cfg, JScheme.parse("2x8g8"), mode=mode,
                                   dtype=dtype)
    key = [jax.random.PRNGKey(1)]

    def wrap(li, name, q):
        if name not in TARGETS:
            return q
        key[0], k = jax.random.split(key[0])
        a = jax.random.normal(k, (r, cfg.hidden_size), jnp.float32) / jnp.sqrt(jnp.float32(r))
        return JLoraLinear(base=q, lora_a=a, lora_b=jnp.zeros((q.out_features, r)), scale=16.0 / r)

    jp = j_map_quantized_linears(jp, wrap)
    return cfg, jp, params_from_numpy(to_numpy_tree(jp), device="cpu")


def _adapter_pairs(jstate, state, fields=("lora_a", "lora_b")):
    for li in range(TINY["num_layers"]):
        for name in TARGETS:
            jl, lin = jstate.adapters["layers"][li][name], state.adapters["layers"][li][name]
            for field in fields:
                yield f32(getattr(lin, field)), np.asarray(getattr(jl, field), np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("mode", ["codes", "int8", "reference"])
def test_lora_step_matches_jax(mode, dtype):
    exact = mode == "reference" and dtype == "f32"
    cfg, jp, p = lora_pair(mode, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    opt = optax.adam(LR)
    jstate, jstep = jlora.init_lora_state(jp, opt), jlora.make_lora_step(cfg, opt)
    state = init_lora_state(p, lambda params: torch.optim.Adam(params, lr=LR))
    step = make_lora_step(llama.ModelConfig.tiny(**TINY))
    want, got = [], []
    for i in range(STEPS):
        jstate, jl = jstep(jstate, jnp.asarray(ids, jnp.int32))
        state, loss = step(state, torch.from_numpy(ids))
        want.append(float(jl))
        got.append(float(loss))
        if i == 0:
            agree = [np.abs(a - b) <= 1e-4 for a, b in _adapter_pairs(jstate, state, ("lora_b",))]
            assert np.mean(np.concatenate([x.ravel() for x in agree])) >= 0.97
    assert state.step == STEPS
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5 if exact else 1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5 if exact else 2.5e-2 if dtype == "bf16" else 5e-3)
    assert got[-1] < got[0] - 1e-3 and want[-1] < want[0] - 1e-3
    for a, b in _adapter_pairs(jstate, state):
        np.testing.assert_allclose(a, b, atol=5e-5 if exact else 8 * LR, rtol=0)
    # the tree given to init_lora_state is untouched: its adapters were copied
    q0 = p["layers"][0]["q_proj"]
    assert not q0.lora_b.any()
    final = merge_trainable(state.adapters, state.frozen)
    base = final["layers"][0]["q_proj"].base
    assert all(getattr(base, n) is getattr(q0.base, n) for n in base.data_fields)  # frozen, shared
    assert float(final["layers"][0]["q_proj"].lora_b.detach().abs().max()) > 0
    assert not isinstance(final["layers"][0]["gate_proj"], LoraLinear)
