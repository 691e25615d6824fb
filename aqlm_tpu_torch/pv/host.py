"""Host-memory straight-through buffers with a round-robin window (PyTorch
counterpart of ``aqlm_tpu.pv.host``).

Every layer's f32 ST buffers and their Adam moments live in host memory
(pinned when the card is used, so the window's copies are direct DMA); each
PV step activates a window of layers (``active_window``) whose buffers go to
the device for the gradient pass, and Adam for the buffers runs on the host
(f32 arithmetic, eps 1e-8, JAX's). Over ceil(L / window) steps every layer's
codes get a V step. The continuous params stay on the device and update
every step.
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

__all__ = ["HostSTManager"]


def _np_dequantize(lin: QuantizedLinear) -> torch.Tensor:
    """A reference-mode projection dequantized on the host: f32 [out, in]
    (per-codebook row gathers, then the scales)."""
    codes = lin.codes.detach().cpu().long()  # [OG, IG, K], read unsigned
    cb = lin.codebooks.detach().cpu().float()  # [K, S, og, ig]
    scales = lin.scales.detach().cpu().float()
    og_n, ig_n, K = codes.shape
    _, s, og, ig = cb.shape
    flat = None
    for k in range(K):
        part = torch.index_select(cb[k].reshape(s, og * ig), 0, codes[:, :, k].reshape(-1))
        flat = part if flat is None else flat.add_(part)
    sflat = scales.repeat_interleave(ig_n) if scales.ndim == 1 else scales.reshape(-1)
    flat.mul_(sflat[:, None])
    groups = flat.reshape(og_n, ig_n, og, ig)
    return groups.permute(0, 2, 1, 3).reshape(og_n * og, ig_n * ig).contiguous()


class HostSTManager:
    """Full-model ST buffers + Adam moments in host memory.

    Per training step (see ``cli.finetune``):
        active = mgr.active_window(step)        # layer indices
        st = mgr.fetch(active, device)          # the st_buffers list of PVState
        ... grad_fn, its ST gradients g_st ...
        mgr.adam_update(active, g_st)           # host Adam
        st = mgr.fetch(active, device)          # the updated buffers, for the V step
    """

    def __init__(self, params: dict, *, window: int = 1, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, moment_dtype=torch.float32):
        on_card = params["embed"].device.type == "cuda"
        pin = (lambda t: t.pin_memory()) if on_card else (lambda t: t)
        self.window = window
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.n_layers = len(params["layers"])
        self.buffers: list[dict[str, torch.Tensor]] = []
        self.m: list[dict[str, torch.Tensor]] = []
        self.v: list[dict[str, torch.Tensor]] = []
        self.t: list[dict[str, int]] = []
        for layer in params["layers"]:
            entry, me, ve, te = {}, {}, {}, {}
            for name in QUANTIZABLE_PROJS:
                lin = layer.get(name)
                if isinstance(lin, QuantizedLinear):
                    entry[name] = pin(_np_dequantize(lin))
                    me[name] = pin(torch.zeros(entry[name].shape, dtype=moment_dtype))
                    ve[name] = pin(torch.zeros(entry[name].shape, dtype=moment_dtype))
                    te[name] = 0
            self.buffers.append(entry)
            self.m.append(me)
            self.v.append(ve)
            self.t.append(te)

    def active_window(self, step: int) -> tuple[int, ...]:
        """The round-robin window of layer indices active at ``step``."""
        n_windows = -(-self.n_layers // self.window)
        w = step % n_windows
        return tuple(range(w * self.window, min((w + 1) * self.window, self.n_layers)))

    def fetch(self, active: tuple[int, ...], device=None) -> list[dict]:
        """The st_buffers list for PVState: copies of the active layers'
        buffers on ``device`` (the host when None), {} elsewhere."""
        dev = torch.device("cpu") if device is None else device
        return [{k: v.to(dev, copy=True) for k, v in self.buffers[li].items()}
                if li in active else {} for li in range(self.n_layers)]

    def fetch_window(self, active: tuple[int, ...]) -> dict[str, torch.Tensor]:
        """The windowed stack {proj: [W, out, in]} (window slot w is layer active[w])."""
        names = list(self.buffers[active[0]].keys())
        return {name: torch.stack([self.buffers[li][name] for li in active]) for name in names}

    def window_to_list(self, active: tuple[int, ...], window: dict) -> list[dict]:
        """A windowed stack (buffers or gradients) as the per-layer list."""
        return [{name: stack[active.index(li)] for name, stack in window.items()}
                if li in active else {} for li in range(self.n_layers)]

    def adam_update(self, active: tuple[int, ...], g_st: list[dict]) -> None:
        """Debiased Adam on the active buffers, on the host in f32."""
        for li in active:
            for name, g in g_st[li].items():
                g = g.detach().to("cpu", torch.float32)
                self.t[li][name] += 1
                t = self.t[li][name]
                m = self.m[li][name].float() * self.b1 + (1 - self.b1) * g
                v = self.v[li][name].float() * self.b2 + (1 - self.b2) * g * g
                self.m[li][name].copy_(m)
                self.v[li][name].copy_(v)
                mhat = m / (1 - self.b1 ** t)
                vhat = v / (1 - self.b2 ** t)
                self.buffers[li][name] -= self.lr * mhat / (torch.sqrt(vhat) + self.eps)

    def store(self, active: tuple[int, ...], st_buffers: list[dict]) -> None:
        """Write the active layers' buffers back (after delta-decay mixing)."""
        for li in active:
            for name, buf in st_buffers[li].items():
                self.buffers[li][name].copy_(buf.detach())
