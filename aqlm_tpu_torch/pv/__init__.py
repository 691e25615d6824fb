"""PV-tuning and PEFT (PyTorch counterpart of ``aqlm_tpu.pv``): the
distillation losses, the configurable Adam, the continuous-param trainer, the
straight-through code updates and LoRA training through frozen quantized
backbones."""

from aqlm_tpu_torch.pv.configurable_adam import (
    ConfigurableAdamState,
    ConfigurableAdamW,
    configurable_adamw,
)
from aqlm_tpu_torch.pv.losses import chunked_kl_loss, cross_entropy_loss, kl_divergence_loss
from aqlm_tpu_torch.pv.lora import (
    LoraTrainState,
    attach_lora,
    init_lora_state,
    make_lora_step,
    merge_lora,
    split_lora,
)
from aqlm_tpu_torch.pv.straight_through import (
    PVConfig,
    PVState,
    init_pv_state,
    make_pv_step,
    pv_code_update,
)
from aqlm_tpu_torch.pv.trainer import (
    TrainState,
    init_train_state,
    make_distill_step,
    merge_trainable,
    split_trainable,
)

__all__ = [
    "ConfigurableAdamState",
    "ConfigurableAdamW",
    "configurable_adamw",
    "PVConfig",
    "PVState",
    "init_pv_state",
    "make_pv_step",
    "pv_code_update",
    "chunked_kl_loss",
    "cross_entropy_loss",
    "kl_divergence_loss",
    "TrainState",
    "init_train_state",
    "make_distill_step",
    "merge_trainable",
    "split_trainable",
    "LoraTrainState",
    "attach_lora",
    "init_lora_state",
    "make_lora_step",
    "merge_lora",
    "split_lora",
]
