"""Token sampling: greedy / temperature / top-k / top-p (PyTorch counterpart
of ``aqlm_tpu.serve.sampler``). Per-row temperature and top_p are tensors so
heterogeneous requests share one step; randomness comes from a
``torch.Generator`` (its numbers differ from JAX's for the same seed, so only
greedy decoding matches the JAX package token for token)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingParams", "sample_tokens", "filter_logits"]


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
                  top_k: int = 0) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits [B, V] (f32, -inf at
    masked entries); their softmax is the sampling distribution."""
    logits = logits.float()
    v = logits.shape[-1]
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp
    if top_k and top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -torch.inf), scaled)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p.float()[:, None]).sum(dim=-1).clamp(max=v - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
    return torch.where(scaled < cutoff, torch.full_like(scaled, -torch.inf), scaled)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0
    max_new_tokens: int = 128
    eos_token_id: int | None = None


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: torch.Tensor, top_p: torch.Tensor, top_k: int = 0, *,
                  any_sampling: bool | None = None) -> torch.Tensor:
    """Next token ids [B] (int64): argmax where temperature == 0, else a
    draw from the filtered distribution.

    ``any_sampling`` says whether some row has temperature > 0, when the
    caller knows it on the host (the Engine keeps the temperatures there);
    None reads it from ``temperature``, which waits for the device."""
    greedy = torch.argmax(logits.float(), dim=-1)
    if any_sampling is None:
        any_sampling = bool((temperature > 0).any())
    if not any_sampling:
        return greedy
    probs = torch.softmax(filter_logits(logits, temperature, top_p, top_k), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature > 0, sampled, greedy)
