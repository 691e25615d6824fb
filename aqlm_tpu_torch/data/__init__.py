"""Data (PyTorch counterpart of ``aqlm_tpu.data``): the offline loaders,
preprocessing, perplexity evaluation and sequence scoring."""

from aqlm_tpu_torch.data.eval import evaluate_perplexity, evaluate_perplexity_sharded
from aqlm_tpu_torch.data.loaders import get_loaders, group_texts, split_long_texts
from aqlm_tpu_torch.data.scoring import make_lm_eval_adapter, score_batch, score_loglikelihood

__all__ = [
    "evaluate_perplexity",
    "evaluate_perplexity_sharded",
    "get_loaders",
    "group_texts",
    "split_long_texts",
    "make_lm_eval_adapter",
    "score_batch",
    "score_loglikelihood",
]
