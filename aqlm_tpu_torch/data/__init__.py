"""Calibration data (PyTorch counterpart of ``aqlm_tpu.data``): the
offline loaders."""

from aqlm_tpu_torch.data.loaders import get_loaders

__all__ = ["get_loaders"]
