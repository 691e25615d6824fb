"""Serving: continuous-batching engine, sampler, KV cache."""

from aqlm_tpu_torch.models.stacked import KVCache, forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.serve.engine import Engine, Request, ServeConfig
from aqlm_tpu_torch.serve.fuse import (
    fuse_projections,
    fuse_projections_codes,
    quantize_lm_head_int8,
)
from aqlm_tpu_torch.serve.sampler import SamplingParams, sample_tokens
from aqlm_tpu_torch.serve.speculative import SpeculativeDecoder

__all__ = [
    "KVCache",
    "forward_stacked",
    "init_kv_cache",
    "stack_layer_params",
    "Engine",
    "Request",
    "ServeConfig",
    "fuse_projections",
    "fuse_projections_codes",
    "quantize_lm_head_int8",
    "SamplingParams",
    "sample_tokens",
    "SpeculativeDecoder",
]
