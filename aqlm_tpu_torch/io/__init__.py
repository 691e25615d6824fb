"""The canonical checkpoint format written and read by aqlm_tpu.io.checkpoint,
and the port's training-state checkpoints (``io.train_state``)."""

from aqlm_tpu_torch.io.checkpoint import (
    load_layer_checkpoint,
    load_quantized_model,
    save_layer_checkpoint,
    save_quantized_model,
)
from aqlm_tpu_torch.io.train_state import load_pytree, save_pytree

__all__ = ["load_layer_checkpoint", "load_quantized_model", "save_layer_checkpoint",
           "save_quantized_model", "save_pytree", "load_pytree"]
