"""ConfigurableAdamW as a ``torch.optim.Optimizer`` (PyTorch counterpart of
``aqlm_tpu.pv.configurable_adam``).

Adam / AMSGrad / Lamb with the JAX transformation's exact update, which
``torch.optim.AdamW`` is not (its eps sits after the debiasing of v, and its
decay is a separate pre-scale):

- u = m / (sqrt(v) + eps), eps 1e-6 by default, with the moments' own
  (undebiased) values; AMSGrad divides by the running max of v instead;
- debiasing (``debias=None``: on for Adam, off for Lamb) multiplies the whole
  update by (1 / (1 - b1^t)) / sqrt(1 / (1 - b2^t));
- Adam's decay adds -lr * wd * p_old to the delta;
- Lamb adds wd * p to u before the trust ratio ||p|| / ||u|| (||p`` clamped
  by ``clamp_value``; 1 when either norm is 0), per tensor;
- the moments are stored in ``exp_avg_dtype`` / ``exp_avg_sq_dtype`` /
  ``v_hat_max_dtype`` (f32 when None) and the arithmetic runs in f32; the
  delta is cast to the parameter's dtype before it is added.

The state is made at construction (zeros, as optax's ``init``), so a
freshly built optimizer has the layout a saved one restores into.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = ["ConfigurableAdamW", "ConfigurableAdamState", "configurable_adamw"]


class ConfigurableAdamState(NamedTuple):
    """One tensor's optimizer state (``ConfigurableAdamW.state_of``); None
    where the configuration keeps no such moment."""

    step: int
    exp_avg: torch.Tensor | None
    exp_avg_sq: torch.Tensor | None
    v_hat_max: torch.Tensor | None


_MOMENTS = ("exp_avg", "exp_avg_sq", "v_hat_max")


class ConfigurableAdamW(torch.optim.Optimizer):
    """See the module docstring. Every parameter gets an update at each
    ``step()``: one without a ``.grad`` is updated with a zero gradient, as
    JAX's tree update gives every leaf one."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, *, debias: bool | None = None, amsgrad: bool = False,
                 lamb: bool = False, clamp_value: float | None = None, exp_avg_dtype=None,
                 exp_avg_sq_dtype=None, v_hat_max_dtype=None):
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        debias=(not lamb) if debias is None else debias, amsgrad=amsgrad,
                        lamb=lamb, clamp_value=clamp_value,
                        dtypes=(exp_avg_dtype, exp_avg_sq_dtype, v_hat_max_dtype))
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self._init_state(p, group)

    def _kept(self, group) -> tuple[bool, bool, bool]:
        """Which of exp_avg, exp_avg_sq and v_hat_max the configuration keeps."""
        use_v = group["b2"] != 1
        return group["b1"] != 0, use_v and group["b2"] != 0, group["amsgrad"]

    def _init_state(self, p, group) -> None:
        st = self.state[p]
        st["step"] = 0
        for name, kept, dtype in zip(_MOMENTS, self._kept(group), group["dtypes"]):
            if kept:
                st[name] = torch.zeros_like(p, dtype=dtype or torch.float32,
                                            memory_format=torch.contiguous_format)

    def state_of(self, p: torch.Tensor) -> ConfigurableAdamState:
        st = self.state[p]
        return ConfigurableAdamState(st["step"], *(st.get(n) for n in _MOMENTS))

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, then the moments back in
        their configured dtypes (the base class casts them to the params')."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["step"] = int(st["step"])
                for name, dtype in zip(_MOMENTS, group["dtypes"]):
                    if name in st:
                        st[name] = st[name].to(dtype or torch.float32)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2, eps, wd = (group[k] for k in ("lr", "b1", "b2", "eps", "weight_decay"))
            use_v = b2 != 1
            for p in group["params"]:
                st = self.state[p]
                st["step"] += 1
                t = st["step"]
                g = torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                if b1 != 0:
                    upd = st["exp_avg"].float() * b1 + g * (1 - b1)
                    st["exp_avg"] = upd.to(st["exp_avg"].dtype)
                else:
                    upd = g
                if use_v:
                    if b2 == 0:
                        v = g * g
                    else:
                        v = st["exp_avg_sq"].float() * b2 + g * g * (1 - b2)
                        st["exp_avg_sq"] = v.to(st["exp_avg_sq"].dtype)
                    if group["amsgrad"]:
                        v = torch.maximum(st["v_hat_max"].float(), v)
                        st["v_hat_max"] = v.to(st["v_hat_max"].dtype)
                    upd = upd / (torch.sqrt(v) + eps)
                if group["lamb"] and wd != 0:
                    upd = upd + wd * p.float()
                scale = -lr
                if group["debias"]:
                    mt = 1.0 / (1 - b1 ** t) if b1 != 0 else 1.0
                    vt = 1.0 / (1 - b2 ** t) ** 0.5 if b2 != 0 else 1.0
                    scale = scale * (mt / vt)
                if group["lamb"]:
                    wnorm = torch.linalg.vector_norm(p.float())
                    if group["clamp_value"] is not None:
                        wnorm = torch.clamp(wnorm, max=group["clamp_value"])
                    unorm = torch.linalg.vector_norm(upd)
                    trust = torch.where((wnorm == 0) | (unorm == 0), 1.0,
                                        wnorm / torch.clamp(unorm, min=1e-30))
                    delta = (scale * trust * upd).to(p.dtype)
                else:
                    delta = (scale * upd).to(p.dtype)
                    if wd != 0:
                        delta = delta - (lr * wd) * p
                p.add_(delta)
        return loss


def configurable_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-6, weight_decay: float = 0.0, **kw):
    """The JAX factory's signature: returns ``make(params) -> ConfigurableAdamW``
    with these settings (what ``init_pv_state`` and ``init_train_state`` take)."""
    return functools.partial(ConfigurableAdamW, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay, **kw)
