"""Shared CLI plumbing (PyTorch counterpart of ``aqlm_tpu.cli.common``):
model resolution, the tokenizer and data.

Models: ``random:<preset>[:layers]`` (random weights from a seeded
``torch.Generator``: other numbers than ``aqlm_tpu``'s from the same seed)
and a directory in the canonical format, canonical or materialized in a
runtime mode. HF checkpoint directories are not ported (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from aqlm_tpu_torch.data import get_loaders
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported

__all__ = ["resolve_model", "load_tokenizer", "load_calibration_data", "dtype_from_str"]


def dtype_from_str(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "auto": torch.float32}[name]


def resolve_model(spec: str, *, dtype=torch.float32, mode: str = "reference", device=None):
    """(params, cfg, kind) with kind ``dense`` or ``quantized``, on ``device``
    (None = the card), from ``random:<preset>[:layers]`` (presets are
    ModelConfig classmethods: random:tiny, random:llama2_7b:2; ``dtype`` is
    theirs) or a canonical directory, as ``aqlm_tpu`` resolves it: a
    checkpoint materialized in ``mode`` (or one with no quantized layer)
    loads as it is, a canonical one is transcoded to ``mode`` at load
    (``convert_runtime_mode``), and one materialized in another mode raises
    ``ValueError``."""
    dev = resolve_device(device)
    if spec.startswith("random:"):
        parts = spec.split(":")
        cfg = getattr(llama.ModelConfig, parts[1])()
        if len(parts) > 2:
            cfg = dataclasses.replace(cfg, num_layers=int(parts[2]))
        gen = torch.Generator(device=dev).manual_seed(0)
        return llama.init_random_params(gen, cfg, dtype=dtype, device=dev), cfg, "dense"

    config_path = os.path.join(spec, "config.json")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"no config.json under {spec}")
    with open(config_path) as f:
        config = json.load(f)
    if "model_config" not in config:
        raise not_ported("loading an HF checkpoint directory", "A10")
    from aqlm_tpu_torch.io import load_quantized_model
    from aqlm_tpu_torch.models.quantize import convert_runtime_mode

    stored = config.get("runtime_mode", "reference")
    if stored not in ("reference", mode):  # materialized layouts are saved only with quantized layers
        raise ValueError(
            f"{spec} is a materialized {stored!r} checkpoint; requested mode {mode!r} needs the "
            f"canonical checkpoint (or reconvert with `convert --to {mode}`)")
    params, cfg = load_quantized_model(spec, device=dev)
    if stored == mode or not any(isinstance(v, QuantizedLinear)
                                 for layer in params["layers"] for v in layer.values()):
        return params, cfg, "quantized"
    return convert_runtime_mode(params, mode), cfg, "quantized"


def load_tokenizer(spec: str):
    """The HF tokenizer saved in the local model directory ``spec``; None
    when ``transformers`` or the tokenizer is missing (ids are used then).
    Nothing is downloaded."""
    if not os.path.isdir(spec):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(spec, local_files_only=True)
    except Exception:
        return None


def load_calibration_data(dataset: str, nsamples: int, seqlen: int, cfg, seed: int = 0,
                          eval_mode: bool = False) -> torch.Tensor:
    """Token ids [nsamples, seqlen] (int64, on the host)."""
    ids = get_loaders(dataset, nsamples=nsamples, seqlen=seqlen, vocab_size=cfg.vocab_size,
                      seed=seed, eval_mode=eval_mode)
    return torch.from_numpy(ids).long()
