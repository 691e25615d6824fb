"""PV-tuning and PEFT (PyTorch counterpart of ``aqlm_tpu.pv``): so far the
trainable/frozen split that the calibration's block finetune uses, the
cross-entropy loss and LoRA training through frozen quantized backbones."""

from aqlm_tpu_torch.pv.losses import cross_entropy_loss
from aqlm_tpu_torch.pv.lora import (
    LoraTrainState,
    attach_lora,
    init_lora_state,
    make_lora_step,
    merge_lora,
    split_lora,
)
from aqlm_tpu_torch.pv.trainer import merge_trainable, split_trainable

__all__ = [
    "cross_entropy_loss",
    "split_trainable",
    "merge_trainable",
    "LoraTrainState",
    "attach_lora",
    "init_lora_state",
    "make_lora_step",
    "merge_lora",
    "split_lora",
]
