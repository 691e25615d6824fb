"""Utilities (PyTorch counterpart of ``aqlm_tpu.utils``): so far the metrics
and profiling helpers of ``utils.monitoring``."""

from aqlm_tpu_torch.utils.monitoring import (
    MetricLogger,
    device_memory_stats,
    print_runtime_stats,
    profile_trace,
)

__all__ = ["MetricLogger", "device_memory_stats", "print_runtime_stats", "profile_trace"]
