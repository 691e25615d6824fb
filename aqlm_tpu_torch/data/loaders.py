"""Calibration and evaluation data loaders (PyTorch counterpart of
``aqlm_tpu.data.loaders``): ``random`` token ids and pre-tokenized
``.npy``/``.npz`` files, and the finetune preprocessing helpers
(``split_long_texts``, ``group_texts``).

The random ids come from numpy's ``RandomState(seed)``, as in ``aqlm_tpu``,
so both packages calibrate on the same ids. The HF datasets (wikitext2, ptb,
c4, pajama) are not ported (ROADMAP A11).
"""

from __future__ import annotations

import os

import numpy as np

from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["get_loaders", "split_long_texts", "group_texts"]


def _random_tokens(nsamples: int, seqlen: int, vocab_size: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab_size, size=(nsamples, seqlen), dtype=np.int32)


def _load_custom(path: str, nsamples: int, seqlen: int) -> np.ndarray:
    """Pre-tokenized ids from .npy/.npz (a flat stream or [n, seqlen])."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            tokens = data[data.files[0]]
    else:
        tokens = np.load(path)
    tokens = np.asarray(tokens)
    if tokens.ndim == 1:
        n_avail = len(tokens) // seqlen
        tokens = tokens[: n_avail * seqlen].reshape(n_avail, seqlen)
    if nsamples > 0:
        tokens = tokens[:nsamples]
    return tokens.astype(np.int32)


def get_loaders(name: str, nsamples: int = 128, seqlen: int = 4096, *, tokenizer=None,
                vocab_size: int = 32000, seed: int = 0, eval_mode: bool = False) -> np.ndarray:
    """Token ids [nsamples, seqlen] int32. ``name``: ``random`` or a path to a
    .npy/.npz file; ``tokenizer`` and ``eval_mode`` matter only to the HF
    datasets, as in ``aqlm_tpu``."""
    if name == "random":
        return _random_tokens(nsamples, seqlen, vocab_size, seed)
    if os.path.exists(name) or name.endswith((".npy", ".npz")):
        return _load_custom(name, nsamples, seqlen)
    raise not_ported(f"the dataset {name!r} (HF datasets)", "A11")


def split_long_texts(texts, max_chars: int) -> list:
    """Documents cut into pieces of at most ``max_chars`` characters."""
    out = []
    for t in texts:
        for start in range(0, len(t), max_chars):
            out.append(t[start:start + max_chars])
    return out


def group_texts(token_lists, seqlen: int, add_labels: bool = False):
    """Tokenized documents concatenated and regrouped into [n, seqlen]
    int32 chunks (the tail dropped); with ``add_labels`` a dict of
    ``input_ids`` and a copy as ``labels``."""
    flat = np.concatenate([np.asarray(t, np.int32).reshape(-1) for t in token_lists])
    n = len(flat) // seqlen
    ids = flat[: n * seqlen].reshape(n, seqlen)
    if add_labels:
        return {"input_ids": ids, "labels": ids.copy()}
    return ids
