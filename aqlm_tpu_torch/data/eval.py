"""Perplexity evaluation, GPTQ protocol (PyTorch counterpart of
``aqlm_tpu.data.eval``): exp(mean next-token NLL) over [nseq, seqlen]
windows, a forward per batch of windows on the params' device.

The data-parallel form waits for the port's parallelism (ROADMAP A14).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["evaluate_perplexity", "evaluate_perplexity_sharded"]


def _window_nll(params: dict, cfg, ids: torch.Tensor, forward_fn=llama.forward) -> torch.Tensor:
    """Per-row NLL sums [B] (f32) of the next-token predictions of ``ids``
    [B, T] (on the params' device); ``log_softmax`` in f32."""
    logits, _ = forward_fn(params, cfg, ids)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, ids[:, 1:, None])[..., 0].sum(-1)


def evaluate_perplexity(params: dict, cfg, input_ids, *, batch_size: int = 1,
                        forward_fn=llama.forward) -> float:
    """exp(total NLL / total tokens) over next-token predictions of
    ``input_ids`` [nseq, seqlen]. The last batch is padded to ``batch_size``
    rows, as ``aqlm_tpu`` keeps its shapes static, and the padded rows' sums
    are dropped."""
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long)
    nseq, seqlen = ids.shape
    dev = params["embed"].device
    total_nll, total_tokens = 0.0, 0
    with torch.inference_mode():
        for start in range(0, nseq, batch_size):
            batch = ids[start:start + batch_size]
            valid = batch.shape[0]
            if valid != batch_size:
                batch = torch.cat([batch, batch.new_zeros((batch_size - valid, seqlen))])
            row_sums = _window_nll(params, cfg, batch.to(dev), forward_fn)
            total_nll += float(row_sums[:valid].sum())
            total_tokens += valid * (seqlen - 1)
    return math.exp(total_nll / max(total_tokens, 1))


def evaluate_perplexity_sharded(params: dict, cfg, input_ids, mesh, **_):
    raise not_ported("data-parallel perplexity (evaluate_perplexity_sharded)", "A14")
