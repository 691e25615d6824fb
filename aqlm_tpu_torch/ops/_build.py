"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by ``nvcc`` at first use
(one ``nvcc -c`` per source, all started together) and linked into one
shared library with a plain C interface, which ``ctypes`` loads. The library
lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources so an edit forces a rebuild.

Each kernel also carries a plain launch counter: its wrapper adds one where
it launches the kernel and nowhere else, so a run can show that its main
path went through the kernel; the kernels whose wrappers come in an
unindexed and a layer-indexed form (K1, K2, the int8 and int4 matmuls) also
count each form apart (``forms``). The split kernels' tickets (``tickets``) are
kept here, per device and stream, for every kernel that zeroes its own, and
so is the f32 scratch of kernels that merge partial sums in a second pass
(``scratch``).
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
    "BUILD_DIR", "KERNELS", "KernelInfo", "library", "check", "count", "reset_launch_counts",
    "stream_ptr",
    "sm_count", "tickets", "scratch",
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
    forms: dict = dataclasses.field(default_factory=dict)  # launches by wrapper form


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
    # B6: K3's loops without the row write (the unindexed form is layer 0)
    "flash_decode": KernelInfo(
        "flash_decode", "aqlm_tpu_torch/ops/csrc/flash_decode.cu",
        "aqlm_tpu/ops/flash_decode.py:152", ("aqlm_tpu/ops/flash_decode.py:656",),
    ),
    # B8: the in-place row write, k/v/scales in one launch (the one-array form too)
    "kv_write": KernelInfo(
        "kv_write", "aqlm_tpu_torch/ops/csrc/kv_write.cu",
        "aqlm_tpu/ops/flash_decode.py:524", ("aqlm_tpu/ops/flash_decode.py:464",),
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
    # K1 over all experts of a Kx8 codes projection at once (<= 8 rows): its own count
    "lut_moe_gemv": KernelInfo(
        "lut_moe_gemv", "aqlm_tpu_torch/ops/csrc/lut_gemv.cu",
        "aqlm_tpu/ops/lut_gemv.py:351", ("aqlm_tpu/ops/lut_gemv.py:272",),
    ),
    # the same function at more than 8 rows: K2's f32 instance, all experts in one launch
    "moe_gather_prefill": KernelInfo(
        "moe_gather_prefill", "aqlm_tpu_torch/ops/csrc/gather_prefill.cu",
        "aqlm_tpu/ops/lut_gemv.py:351", ("aqlm_tpu/ops/lut_gemv.py:272",),
    ),
    # 1x16 codes (B1; XLA on the TPU, not a pallas_call): the GEMV (<= 8 rows) and the GEMM
    "gather16_gemv": KernelInfo(
        "gather16_gemv", "aqlm_tpu_torch/ops/csrc/gather16.cu",
        "aqlm_tpu/ops/gather16.py:72", (),
    ),
    "gather16_gemm": KernelInfo(
        "gather16_gemm", "aqlm_tpu_torch/ops/csrc/gather16.cu",
        "aqlm_tpu/ops/gather16.py:72", (),
    ),
    # codes mode at out_features not a multiple of 128 (untiled codes), both forms
    "onehot_matmul": KernelInfo(
        "onehot_matmul", "aqlm_tpu_torch/ops/csrc/onehot_matmul.cu",
        "aqlm_tpu/ops/kernels.py:159", (),
    ),
    # B13: the differentiable dequant's forward (calibration, reference-mode matmuls)
    "dequantize_onehot": KernelInfo(
        "dequantize_onehot", "aqlm_tpu_torch/ops/csrc/calib_dequant.cu",
        "aqlm_tpu/ops/kernels.py:307", (),
    ),
    # B14: its backward, the codebook-gradient segment sum
    "cb_grad_segment": KernelInfo(
        "cb_grad_segment", "aqlm_tpu_torch/ops/csrc/calib_dequant.cu",
        "aqlm_tpu/ops/kernels.py:244", (),
    ),
    # B5: the dense W^T from tiled codes (the codes-mode activation backward)
    "gather_dequant_wt": KernelInfo(
        "gather_dequant_wt", "aqlm_tpu_torch/ops/csrc/gather_dequant_wt.cu",
        "aqlm_tpu/ops/gather_prefill.py:331", (),
    ),
    # B16: the lane-gather wrap probe (on no path: the port's kernels never consult it)
    "gather_wraps": KernelInfo(
        "gather_wraps", "aqlm_tpu_torch/ops/csrc/gather_wraps.cu",
        "aqlm_tpu/ops/kernels.py:75", (),
    ),
    # B10: dx = bf16(g * scale) @ w8 (the int8-mode activation backward)
    "int8_matmul_transposed": KernelInfo(
        "int8_matmul_transposed", "aqlm_tpu_torch/ops/csrc/int8_matmul.cu",
        "aqlm_tpu/ops/int8_matmul.py:153", (),
    ),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.forms = {}


def count(name: str, form: str | None = None) -> None:
    """One launch of kernel ``name``, made by its wrapper's ``form``
    (``unindexed`` or ``indexed``) where the kernel has both."""
    k = KERNELS[name]
    k.launches += 1
    if form is not None:
        k.forms[form] = k.forms.get(form, 0) + 1


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
    L = ctypes.c_longlong
    lib.lut_gemv_launch.argtypes = [P] * 8 + [I] * 10 + [L] + [I] * 8 + [P]
    lib.gather_prefill_launch.argtypes = [P] * 8 + [I] * 15 + [L, I, P]
    lib.gather16_gemv_launch.argtypes = [P] * 5 + [I] * 8 + [P]
    lib.gather16_wt_launch.argtypes = [P] * 3 + [L, I, I, P]
    lib.gather16_gemm_launch.argtypes = [P] * 6 + [I] * 8 + [P]
    lib.flash_decode_write_launch.argtypes = [P] * 14 + [I] * 10 + [ctypes.c_float, P]
    lib.int8_matmul_launch.argtypes = [P] * 6 + [I] * 11 + [P]
    lib.int4_matmul_launch.argtypes = [P] * 6 + [I] * 11 + [P]
    lib.int4_gemv_launch.argtypes = [P] * 4 + [I] * 9 + [P]
    lib.int8_gemv_launch.argtypes = [P] * 4 + [I] * 9 + [P]
    lib.onehot_matmul_launch.argtypes = [P] * 7 + [I] * 12 + [P]
    lib.calib_dequant_launch.argtypes = [P] * 4 + [L] + [I] * 5 + [P]
    lib.cb_grad_launch.argtypes = [P] * 4 + [L] + [I] * 7 + [P]
    lib.gather_dequant_wt_launch.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.int8_matmul_t_launch.argtypes = [P] * 7 + [I] * 9 + [P]
    lib.flash_decode_launch.argtypes = [P] * 10 + [I] * 12 + [ctypes.c_float, P]
    lib.kv_write_launch.argtypes = [ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(I), I, P,
                                    I, I, I, P]
    lib.gather_wraps_launch.argtypes = [P] * 3 + [I, P]
    for fn in (lib.lut_gemv_launch, lib.gather_prefill_launch,
               lib.gather16_gemv_launch, lib.gather16_wt_launch, lib.gather16_gemm_launch,
               lib.flash_decode_write_launch,
               lib.int8_matmul_launch, lib.int8_gemv_launch, lib.int4_matmul_launch,
               lib.int4_gemv_launch,
               lib.onehot_matmul_launch,
               lib.calib_dequant_launch, lib.cb_grad_launch, lib.gather_dequant_wt_launch,
               lib.int8_matmul_t_launch, lib.flash_decode_launch, lib.kv_write_launch,
               lib.gather_wraps_launch):
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


_TICKETS: dict = {}


def tickets(dev, n: int) -> torch.Tensor:
    """Split kernels' tickets, int32 zeros kept per (device, stream): every
    launch of a kernel that takes them leaves them zero (the last block of
    each tile or row zeroes its own), so they are zeroed once, and launches
    on one stream run in order, so no two of them share a ticket at once.
    Launches on two streams take two buffers (a captured CUDA graph keeps
    its capture stream's). A larger need allocates anew and keeps the old
    buffer alive (a captured graph may hold it)."""
    bufs = _TICKETS.setdefault((dev.index, stream_ptr(dev)), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=dev))
    return bufs[-1]


_SCRATCH: dict = {}


def scratch(dev, n: int) -> torch.Tensor:
    """f32 scratch of at least ``n`` elements kept per (device, stream), for
    a kernel whose launch writes it and reads it back before it ends (B14's
    partial sums): launches on one stream run in order, so they share one
    buffer, and launches on two streams take two. A larger need allocates
    anew and keeps the old buffer alive (a captured graph may hold it)."""
    bufs = _SCRATCH.setdefault((dev.index, stream_ptr(dev)), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.empty(n, dtype=torch.float32, device=dev))
    return bufs[-1]
