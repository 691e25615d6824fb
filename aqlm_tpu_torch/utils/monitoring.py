"""Metrics and profiling (PyTorch counterpart of ``aqlm_tpu.utils.monitoring``):
phase timers synchronised with the card, device memory, ``torch.profiler``
traces and a JSONL metric log. Logging to wandb is not ported (ROADMAP A15).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["print_runtime_stats", "MetricLogger", "device_memory_stats", "profile_trace"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def print_runtime_stats(operation: str, enabled: bool = True):
    """Print the wall-clock seconds of the block, the card synchronised
    before and after it."""
    if not enabled:
        yield
        return
    _sync()
    start = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        print(f"{operation} took {time.perf_counter() - start:.3f} s", flush=True)


def device_memory_stats(device=None) -> dict:
    """Live and peak bytes the caching allocator holds for tensors on the
    card (``torch.cuda.memory_stats``) and its memory size; None on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card when
    there is one), written to ``log_dir`` for TensorBoard."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class MetricLogger:
    """Metrics as JSON lines: appended to ``jsonl_path``, or printed when it
    is None."""

    def __init__(self, use_wandb: bool = False, jsonl_path: str | None = None):
        if use_wandb:
            raise not_ported("metric logging to wandb", "A15")
        self._jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def log(self, payload: dict, step: int | None = None):
        line = json.dumps({"step": step, **payload})
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(line + "\n")
        else:
            print(line, flush=True)
