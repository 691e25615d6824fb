"""The L2 gather ceiling of the card: how many random codebook-row gathers a
second it serves while codes stream from device memory, by a hand-written
micro-kernel (built here with nvcc, not part of the package).

    python3 experiments/torch_gather_ceiling.py [OUT_JSON]

Each thread of a full grid (4 blocks of 512 threads an SM) reads uint16
codes (256 MB of them, coalesced, from device memory) and, for each, gathers
the code's row of a table of 65536 rows through L2 (ld.global.cg):

- ``row16``: 16-byte rows (a 1 MB table, the 1x16 g=8 codebook), one lane a row;
- ``row32_pair``: 32-byte rows (2 MB, g=16), two neighbouring lanes load the
  two 16-byte halves of one row in the same instruction (one sector request);
- ``row32_lane``: 32-byte rows, one lane loads both halves (two requests);
- ``row16_nc``: as row16 through L1 (ld.global.nc; the kernel takes no
  shared memory, so the L1 carve-out is at its default).

``inflight`` codes a lane handles at once (1-16): its gathers are issued
before any is used. Reports, for each, device ms (CUDA events, median of 5
after a warm-up), gathers (rows) a second, 32-byte sector requests a second,
gathered bytes a second and the codes' device-memory rate. Writes all to
OUT_JSON (default chiprun_out/gather_ceiling.json). chip_smoke.py calls
``measure(CEILING_CASES)`` for the ceilings it records beside B1's GEMV.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "gather_ceiling")
INFLIGHT = (1, 2, 4, 8, 16)
VARIANTS = {"row16": (1, 0, 0), "row32_pair": (2, 1, 0), "row32_lane": (2, 0, 0), "row16_nc": (1, 0, 1)}
# chip_smoke.py measures these two beside B1's GEMV records
CEILING_CASES = [("row16", 4), ("row32_pair", 4)]

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// ROW16: 16-byte units a table row; PAIRED: two lanes share a row, one unit
// each; NC: loads through L1. Code c is handled by lane group
// c % groups_total, in rounds of INFLIGHT codes.
template <int ROW16, int PAIRED, int NC, int INFLIGHT>
__global__ void __launch_bounds__(512) gather_probe(const uint16_t* __restrict__ codes,
                                                   const uint4* __restrict__ table,
                                                   long long n_codes, uint4* __restrict__ sink) {
  constexpr int LPC = PAIRED ? 2 : 1;
  constexpr int UPL = PAIRED ? 1 : ROW16;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long groups_total = (long long)gridDim.x * blockDim.x / LPC;
  const long long group = tid / LPC;
  const int half = (int)(tid % LPC);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (long long c0 = group; c0 < n_codes; c0 += groups_total * INFLIGHT) {
    uint32_t code[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      const long long c = c0 + (long long)k * groups_total;
      code[k] = c < n_codes ? __ldcs(codes + c) : 0u;
    }
    uint4 v[INFLIGHT][UPL];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k)
#pragma unroll
      for (int u = 0; u < UPL; ++u) {
        const uint4* p = table + (size_t)code[k] * ROW16 + (PAIRED ? half : u);
        v[k][u] = NC ? __ldg(p) : __ldcg(p);
      }
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k)
#pragma unroll
      for (int u = 0; u < UPL; ++u) {
        acc.x ^= v[k][u].x; acc.y += v[k][u].y; acc.z ^= v[k][u].z; acc.w += v[k][u].w;
      }
  }
  if ((acc.x ^ acc.y ^ acc.z ^ acc.w) == 0x9e3779b9u) sink[tid & 1023] = acc;  // keeps the loads
}

#define INST(R, P, N, F)                                                                     \
  extern "C" int probe_##R##_##P##_##N##_##F(const void* codes, const void* table,           \
                                             long long n, void* sink, int blocks, void* s) { \
    gather_probe<R, P, N, F><<<blocks, 512, 0, (cudaStream_t)s>>>(                           \
        (const uint16_t*)codes, (const uint4*)table, n, (uint4*)sink);                       \
    return cudaGetLastError();                                                               \
  }
"""


def build(instances):
    """nvcc the probe with the given (row units, paired, nc, inflight)
    instances into build/gather_ceiling; returns the ctypes library."""
    os.makedirs(BUILD, exist_ok=True)
    tag = "_".join("".join(map(str, i)) for i in instances)
    src = os.path.join(BUILD, f"gather_probe_{tag}.cu")
    lib = os.path.join(BUILD, f"libgather_probe_{tag}.so")
    with open(src, "w") as f:
        f.write(SRC + "".join(f"INST({r}, {p}, {n}, {fl})\n" for r, p, n, fl in instances))
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    return ctypes.CDLL(lib)


def measure(cases, n_codes=128 << 20, repeats=5):
    """Device ms and rates of each (variant name, inflight) in ``cases`` on
    the current card: one record each (see the module docstring)."""
    instances = [(*VARIANTS[v], f) for v, f in cases]
    lib = build(instances)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(0, 65536, (n_codes,), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint16)
    tables = {1: torch.randint(0, 2 ** 31, (65536 * 4,), generator=gen, device=dev, dtype=torch.int32),
              2: torch.randint(0, 2 ** 31, (65536 * 8,), generator=gen, device=dev, dtype=torch.int32)}
    sink = torch.zeros(1024 * 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    records = []
    for (name, f), (r16, paired, nc, _) in zip(cases, instances):
        fn = getattr(lib, f"probe_{r16}_{paired}_{nc}_{f}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call = lambda: fn(codes.data_ptr(), tables[r16].data_ptr(), n_codes, sink.data_ptr(),
                          4 * sms, stream)
        if call() != 0:
            raise RuntimeError(f"gather probe {name} failed to launch")
        torch.cuda.synchronize()
        ts = []
        for _ in range(repeats):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            call()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        ms = statistics.median(ts)
        sectors = n_codes * (1 if r16 == 1 or paired else 2)
        records.append({"variant": name, "row_bytes": 16 * r16, "table_mb": r16, "inflight": f,
                        "ms": ms, "g_rows_per_s": n_codes / (ms * 1e-3) / 1e9,
                        "g_requests_per_s": sectors / (ms * 1e-3) / 1e9,
                        "gather_tb_s": n_codes * 16 * r16 / (ms * 1e-3) / 1e12,
                        "codes_tb_s": n_codes * 2 / (ms * 1e-3) / 1e12})
    del codes, tables, sink
    return records


def main():
    out_json = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out", "gather_ceiling.json")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    records = measure([(v, f) for v in VARIANTS for f in INFLIGHT])
    for rec in records:
        print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)


if __name__ == "__main__":
    main()
