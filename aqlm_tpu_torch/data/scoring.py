"""Sequence scoring (PyTorch counterpart of ``aqlm_tpu.data.scoring``): the
loglikelihood of continuations given contexts, the lm-eval ``loglikelihood``
contract. The lm-eval harness adapter is not ported (ROADMAP A11):
``lm_eval`` is not installed.
"""

from __future__ import annotations

import numpy as np
import torch

from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["score_loglikelihood", "score_batch", "make_lm_eval_adapter"]


def _pad_to(arr, length, value=0):
    out = np.full((length,), value, np.int64)
    out[: len(arr)] = arr
    return out


def score_batch(params, cfg, contexts: list, continuations: list, *, forward_fn=llama.forward,
                pad_len: int | None = None) -> list:
    """[(logprob_sum, is_greedy), ...] of each continuation given its
    context. The sequences are padded with id 0 to a shared length (the
    longest, or ``pad_len``) and scored by one forward on the params'
    device, ``log_softmax`` in f32."""
    assert len(contexts) == len(continuations)
    totals = [len(c) + len(t) for c, t in zip(contexts, continuations)]
    max_len = pad_len or max(totals)
    ids = np.stack([_pad_to(np.concatenate([c, t]), max_len)
                    for c, t in zip(contexts, continuations)])
    with torch.inference_mode():
        logits, _ = forward_fn(params, cfg, torch.from_numpy(ids).to(params["embed"].device))
        lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()  # [n, max_len, V]
    results = []
    for i, (ctx, cont) in enumerate(zip(contexts, continuations)):
        c_len, t_len = len(ctx), len(cont)
        # the token at position p is predicted by the logits at p - 1
        token_lp = lp[i, c_len - 1:c_len + t_len - 1]
        cont = np.asarray(cont, np.int64)
        results.append((float(token_lp[np.arange(t_len), cont].sum()),
                        bool((token_lp.argmax(-1) == cont).all())))
    return results


def score_loglikelihood(params, cfg, context_ids, continuation_ids, *, forward_fn=llama.forward):
    """One (context, continuation) pair: (logprob_sum, is_greedy)."""
    return score_batch(params, cfg, [context_ids], [continuation_ids], forward_fn=forward_fn)[0]


def make_lm_eval_adapter(params, cfg, tokenizer, *, forward_fn=llama.forward, batch_size: int = 4):
    raise not_ported("the lm-eval harness adapter (lm_eval)", "A11")
