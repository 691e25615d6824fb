"""Model-family registry (PyTorch counterpart of ``aqlm_tpu.models.family``):
one place that maps a config to its module and a checkpoint's
``model_family`` name to its config class. The port has the Llama, Mixtral
and Falcon families; the others raise ``NotImplementedError`` (ROADMAP A9)."""

from __future__ import annotations

from aqlm_tpu_torch.models import falcon, llama, mixtral
from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["FAMILY_REGISTRY", "family_name", "family_module", "config_class"]

# name -> (config class, module); subclasses of ModelConfig come before it
FAMILY_REGISTRY = {
    "mixtral": (mixtral.MixtralConfig, mixtral),
    "falcon": (falcon.FalconConfig, falcon),
    "llama": (llama.ModelConfig, llama),
}


def family_name(cfg: llama.ModelConfig) -> str:
    for name, (cls, _) in FAMILY_REGISTRY.items():
        if isinstance(cfg, cls):
            return name
    raise not_ported(f"the {type(cfg).__name__} family", "A9")


def family_module(cfg: llama.ModelConfig):
    return FAMILY_REGISTRY[family_name(cfg)][1]


def config_class(name: str):
    if name not in FAMILY_REGISTRY:
        raise not_ported(f"the {name} family", "A9")
    return FAMILY_REGISTRY[name][0]

