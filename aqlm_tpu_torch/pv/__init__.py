"""PV-tuning (PyTorch counterpart of ``aqlm_tpu.pv``): so far the
trainable/frozen split that the calibration's block finetune uses."""

from aqlm_tpu_torch.pv.trainer import merge_trainable, split_trainable

__all__ = ["split_trainable", "merge_trainable"]
