"""Training losses (PyTorch counterpart of ``aqlm_tpu.pv.losses``): so far the
next-token cross entropy that the LoRA trainer minimises."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token NLL in f32. logits [B, T, V]; labels [B, T] (already
    shifted); mask [B, T] or None (the masked mean over at least one token)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
