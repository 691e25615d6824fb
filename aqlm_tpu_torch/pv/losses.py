"""Training losses (PyTorch counterpart of ``aqlm_tpu.pv.losses``): the
next-token cross entropy that the LoRA trainer minimises, and the
teacher -> student KL of PV-tuning's distillation, whole or in token chunks.

``chunked_kl_loss`` applies both heads per chunk of tokens under
``torch.utils.checkpoint`` (non-reentrant), so the student's and the
teacher's [B, T, V] logits never coexist: a chunk's logits are freed after
its forward and recomputed in its backward.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["kl_divergence_loss", "chunked_kl_loss", "cross_entropy_loss"]


def _kl_terms(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
    sl = torch.log_softmax(student_logits.float(), dim=-1)
    tl = torch.log_softmax(teacher_logits.float(), dim=-1)
    return (torch.exp(tl) * (tl - sl)).sum(dim=-1)


def kl_divergence_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean KL(teacher || student) per token, in f32. Logits [..., V], mask [...]."""
    kl = _kl_terms(student_logits, teacher_logits)
    if mask is None:
        return kl.mean()
    m = mask.float()
    return (kl * m).sum() / torch.clamp(m.sum(), min=1.0)


def _project(hidden, head_weight, embed, softcap, logit_scale=None):
    """Logits [B, T, V] in f32 of ``hidden`` [B, T, H] by the head [V, H] (or
    the tied embedding): the head cast to the hidden dtype, products summed
    in f32."""
    w = head_weight if head_weight is not None else embed
    logits = torch.matmul(hidden.float(), w.to(hidden.dtype).float().t())
    if logit_scale is not None:  # cohere's tied-head scaling
        logits = logits * logit_scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def chunked_kl_loss(student_hidden: torch.Tensor, teacher_hidden: torch.Tensor,
                    student_head: torch.Tensor | None, teacher_head: torch.Tensor | None, *,
                    student_embed: torch.Tensor | None = None,
                    teacher_embed: torch.Tensor | None = None,
                    mask: torch.Tensor | None = None, chunk_tokens: int = 256,
                    softcap: float | None = None,
                    logit_scale: float | None = None) -> torch.Tensor:
    """KL loss from the final hidden states [B, T, H], each head applied per
    chunk of tokens under checkpoint. Heads [V, H], or None with the tied
    embedding; mask [B, T] of valid tokens. The chunk is the largest divisor
    of T up to ``chunk_tokens``, as in JAX. Equal to projecting everything
    and ``kl_divergence_loss``; peak memory O(B * chunk * V)."""
    b, t, _ = student_hidden.shape
    chunk = min(chunk_tokens, t)
    while t % chunk:
        chunk -= 1
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.float32, device=student_hidden.device)
    mask = mask.float()

    def chunk_loss(s, th, m):
        kl = _kl_terms(_project(s, student_head, student_embed, softcap, logit_scale),
                       _project(th, teacher_head, teacher_embed, softcap, logit_scale))
        return torch.stack([(kl * m).sum(), m.sum()])

    parts = [checkpoint(chunk_loss, student_hidden[:, c:c + chunk], teacher_hidden[:, c:c + chunk],
                        mask[:, c:c + chunk], use_reentrant=False)
             for c in range(0, t, chunk)]
    sums, counts = torch.stack(parts).sum(dim=0)
    return sums / torch.clamp(counts, min=1.0)


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
