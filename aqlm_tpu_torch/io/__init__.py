"""The canonical checkpoint format written and read by aqlm_tpu.io.checkpoint."""

from aqlm_tpu_torch.io.checkpoint import (
    load_layer_checkpoint,
    load_quantized_model,
    save_layer_checkpoint,
    save_quantized_model,
)

__all__ = ["load_layer_checkpoint", "load_quantized_model", "save_layer_checkpoint",
           "save_quantized_model"]
