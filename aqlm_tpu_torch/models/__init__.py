"""Model definitions of the port: the Llama, Mixtral and Falcon families, the
family registry, and the stacked serving form."""

from aqlm_tpu_torch.models import falcon, family, llama, mixtral
from aqlm_tpu_torch.models.common import (
    DenseLinear,
    apply_linear,
    attention,
    attention_headmajor,
    make_causal_mask,
    rms_norm,
    rope,
)

__all__ = [
    "falcon",
    "family",
    "llama",
    "mixtral",
    "DenseLinear",
    "apply_linear",
    "attention",
    "attention_headmajor",
    "make_causal_mask",
    "rms_norm",
    "rope",
]
