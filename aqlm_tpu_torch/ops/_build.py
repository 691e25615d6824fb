"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by ``nvcc`` at first use
(one ``nvcc -c`` per source, all started together) and linked into one
shared library with a plain C interface, which ``ctypes`` loads. The library
lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources so an edit forces a rebuild.

Each kernel also carries a plain launch counter: its wrapper adds one where
it launches the kernel and nowhere else, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = [
    "BUILD_DIR", "KERNELS", "KernelInfo", "library", "check", "reset_launch_counts", "stream_ptr",
    "sm_count",
]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclasses.dataclass
class KernelInfo:
    """A hand-written kernel of the port and its launch count."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel's pallas_call on the main path
    also_replaces: tuple
    launches: int = 0


KERNELS = {
    "lut_gemv": KernelInfo(
        "lut_gemv", "aqlm_tpu_torch/ops/csrc/lut_gemv.cu",
        "aqlm_tpu/ops/lut_gemv.py:518",
        ("aqlm_tpu/ops/lut_gemv.py:181", "aqlm_tpu/ops/lut_gemv.py:435"),
    ),
    "gather_prefill": KernelInfo(
        "gather_prefill", "aqlm_tpu_torch/ops/csrc/gather_prefill.cu",
        "aqlm_tpu/ops/gather_prefill.py:510",
        ("aqlm_tpu/ops/gather_prefill.py:285", "aqlm_tpu/ops/gather_prefill.py:416"),
    ),
    "flash_decode_write": KernelInfo(
        "flash_decode_write", "aqlm_tpu_torch/ops/csrc/flash_decode.cu",
        "aqlm_tpu/ops/flash_decode.py:358", (),
    ),
    "int8_matmul": KernelInfo(
        "int8_matmul", "aqlm_tpu_torch/ops/csrc/int8_matmul.cu",
        "aqlm_tpu/ops/int8_matmul.py:231", ("aqlm_tpu/ops/int8_matmul.py:85",),
    ),
    "int4_matmul": KernelInfo(
        "int4_matmul", "aqlm_tpu_torch/ops/csrc/int4_matmul.cu",
        "aqlm_tpu/ops/int4_matmul.py:253", ("aqlm_tpu/ops/int4_matmul.py:178",),
    ),
    # the int8 kernel over all experts at once: its own wrapper and count
    "int8_moe_matmul": KernelInfo(
        "int8_moe_matmul", "aqlm_tpu_torch/ops/csrc/int8_matmul.cu",
        "aqlm_tpu/ops/int8_matmul.py:371", ("aqlm_tpu/ops/int8_matmul.py:294",),
    ),
    # the int4 kernel over all experts at once: its own wrapper and count
    "int4_moe_matmul": KernelInfo(
        "int4_moe_matmul", "aqlm_tpu_torch/ops/csrc/int4_matmul.cu",
        "aqlm_tpu/ops/int4_matmul.py:365", ("aqlm_tpu/ops/int4_matmul.py:295",),
    ),
    # codes mode at out_features not a multiple of 128 (untiled codes), both forms
    "onehot_matmul": KernelInfo(
        "onehot_matmul", "aqlm_tpu_torch/ops/csrc/onehot_matmul.cu",
        "aqlm_tpu/ops/kernels.py:159", (),
    ),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on the machine with the card")


def _build(lib_path: str) -> None:
    srcs = _sources()
    cu = [s for s in srcs if s.endswith(".cu")]
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs, procs = [], []
    for src in cu:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        log = open(obj + ".log", "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", src, "-o", obj],
            stdout=log, stderr=subprocess.STDOUT,
        )))
        objs.append(obj)
    failed = []
    for src, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                failed.append(f"{src} (rc {rc}):\n{f.read()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path + f".tmp{os.getpid()}"
    subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs], check=True)
    os.replace(tmp, lib_path)


@functools.cache
def library():
    """(ctypes library, build seconds): built on first call, then cached."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's kernels need a CUDA device")
    h = hashlib.sha256()
    for s in _sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"libaqlm_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
        _build(lib_path)
    lib = ctypes.CDLL(lib_path)
    _declare(lib)
    return lib, time.perf_counter() - t0


def _declare(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    # pointers..., ints..., stream (see the extern "C" signatures in csrc/)
    lib.lut_gemv_launch.argtypes = [P] * 8 + [I] * 10 + [P]
    lib.gather_prefill_launch.argtypes = [P] * 8 + [I] * 8 + [P]
    lib.flash_decode_write_launch.argtypes = [P] * 11 + [I] * 7 + [ctypes.c_float, P]
    lib.int8_matmul_launch.argtypes = [P] * 6 + [I] * 8 + [P]
    lib.int4_matmul_launch.argtypes = [P] * 6 + [I] * 8 + [P]
    lib.onehot_matmul_launch.argtypes = [P] * 7 + [I] * 8 + [P]
    for fn in (lib.lut_gemv_launch, lib.gather_prefill_launch, lib.flash_decode_write_launch,
               lib.int8_matmul_launch, lib.int4_matmul_launch, lib.onehot_matmul_launch):
        fn.restype = I


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(index) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (sizes split grids)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
