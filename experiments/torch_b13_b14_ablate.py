"""What B13 (the calibration dequant) and B14 (the codebook-gradient segment
sum) spend their time on, on the card: time copies of one package's
``csrc/calib_dequant.cu`` with one part of their work switched off, beside
the card's write and read ceilings, in one process on one card.

    python3 experiments/torch_b13_b14_ablate.py ROOT [OUT_JSON] [VARIANT,...]

ROOT holds the ``aqlm_tpu_torch`` package whose source is ablated (``.`` for
this checkout; ``build/parent`` for a parent commit's package, unpacked with
``git archive <commit> aqlm_tpu_torch | tar -x -C build/parent``). Each
variant is that one source with its patches, built alone by nvcc into
``build/b13_b14_ablate/<design>_<variant>/`` and loaded with ctypes (ROOT's
files are not touched). Two designs have patches, picked by what the source
holds.

The first design (a thread a group in B13; a thread an element, every
resident block, a global-atomic flush in B14):

- ``b13_stores_parent``: B13 writes its groups as it does, with no code
  loads and no gathers (the stores alone, in its lane mapping: a thread's
  two float4s 16 bytes apart, a warp's store spread over 1 KB);
- ``b13_stores_contig``: B13's loop replaced by contiguous float4 stores (a
  warp writes 512 contiguous bytes an instruction);
- ``b13_no_gather``: the codes are loaded, the codebook gather is not (a
  value made from the code takes its place);
- ``b14_loads_only``: B14 loads its data and codes and adds into a register
  (no shared atomics);
- ``b14_no_div``: the division of the element index by g becomes a shift
  (g = 8);
- ``b14_no_flush``: no global atomics from the blocks' copies into the
  output (the memset stays).

The second design (a lane a float4 of W in B13; in B14 one block an SM, a
float2 a thread added into eight bank-interleaved copies, partial sums
merged by a second kernel):

- ``b13_no_gather``, ``b13_stores_only`` (no code loads either),
  ``b13_codes_l2`` (the codes read from the first 64K groups' only, which
  stay in L2: no code bytes from device memory), ``b13_occupancy8`` (at
  most 32 registers, eight blocks an SM), ``b13_units2`` (two units a
  thread a step instead of four);
- ``b14_loads_only`` (data and codes loaded, no shared atomics),
  ``b14_plain_adds`` (the atomics become plain read-add-writes, which race:
  only the time counts), ``b14_unroll4`` / ``b14_unroll12`` /
  ``b14_unroll16`` (2, 6 or 8 float2s a thread a batch instead of 4, twice
  that in flight), ``b14_floats`` (a
  float a thread, four bank-interleaved copies and 32-bit atomics: the
  plan for odd g), ``b14_one_copy`` (one shared copy a block),
  ``b14_no_merge`` (the merge kernel is not launched), ``b14_l2_prefetch``
  (thread 0 of a block asks L2 for the block's data two batches ahead);
- ``b13_byte_codes`` / ``b14_byte_codes``: a group's codes read by K byte
  loads into a 64-bit word (the path for unaligned codes or K of 3, 5-7:
  in B14 two groups a batch, not four), not one load of K bytes;
  ``b13_b14_byte_loads``: at K 2, two byte loads into the same 32-bit word
  as the one 2-byte load (both kernels timed).

``full`` is the source as it is. Beside them: ``fill`` (one ``fill_`` of
the f32 W: the card's write ceiling as PyTorch reaches it) and
``write_ceiling`` / ``read_ceiling`` (a micro-kernel that stores or loads the
f32 W or gradient once as float4s, all SMs, in a grid-stride loop).
Variants' outputs are meaningless; only their times are read (but ``full``
is held against the plain versions: B13 bit-identical, B14 within 1e-5 of
each segment's sum of |data|).

Times are chip_smoke.time_ms (CUDA-graph replays of 20 calls, median of 5),
B13 cycling 4 copies of the codes, at Llama-2-7B's q (4096 x 4096) and gate
(11008 x 4096), K 2, S 256, g 8, unit scales, precise and bf16 modes.
Prints one JSON line per variant, shape and mode and writes all to OUT_JSON
(default chiprun_out/b13_b14_ablate.json), with each design's ptxas report
and the SASS of the full source's B14 kernel (its shared atomics:
``chiprun_out/sass_b14_<design>.txt``).
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import torch  # noqa: E402

from chip_smoke import CALIB_PROJS, HBM_BYTES_PER_S, time_ms  # noqa: E402

SRC = os.path.abspath(sys.argv[1])
OUT_JSON = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "b13_b14_ablate.json")
CSRC = os.path.join(SRC, "aqlm_tpu_torch", "ops", "csrc")
CU = open(os.path.join(CSRC, "calib_dequant.cu")).read()
DESIGN = "merge" if "cb_grad_merge_kernel" in CU else "atomic"
K, S, G8 = 2, 256, 8
COPIES = 4
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
BUILD = os.path.join(HERE, "build", "b13_b14_ablate")

_ATOMIC_B13_GATHER = """        for (int k = 0; k < K; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(
              s_cb + ((size_t)k * S + __ldg(c + k)) * g + j);"""
_ATOMIC_B13_LOOP_HEAD = "    const uint8_t* c = codes + n * K;"
ATOMIC = {
    "full": [],
    "b13_stores_parent": [(_ATOMIC_B13_GATHER, """        for (int k = 0; k < 0; ++k) {
          const float4 v = make_float4(0.f, 0.f, 0.f, 0.f);""")],
    "b13_stores_contig": [(
        "  const long long stride = (long long)gridDim.x * THREADS;\n"
        "  for (long long n = (long long)blockIdx.x * THREADS + threadIdx.x; n < n_groups; n += stride) {\n"
        + _ATOMIC_B13_LOOP_HEAD,
        "  const long long stride = (long long)gridDim.x * THREADS;\n"
        "  for (long long f = (long long)blockIdx.x * THREADS + threadIdx.x; f < n_groups * g / 4; f += stride)\n"
        "    reinterpret_cast<float4*>(out)[f] = make_float4((float)f, 1.f, 2.f, 3.f);\n"
        "  for (long long n = 0; n < 0; n += stride) {\n" + _ATOMIC_B13_LOOP_HEAD)],
    "b13_no_gather": [(_ATOMIC_B13_GATHER, """        for (int k = 0; k < K; ++k) {
          const float4 v = make_float4((float)__ldg(c + k), 0.f, 0.f, 0.f);""")],
    "b14_loads_only": [  # in this order: the first two patches keep the atomic's line whole
        ("      atomicAdd(s_acc + ((size_t)k * S + s) * g + j, v);\n    }\n  }\n  __syncthreads();",
         "      atomicAdd(s_acc + ((size_t)k * S + s) * g + j, v);\n    }\n  }\n"
         "  if (sink == 1.2345f) s_acc[0] = sink;\n  __syncthreads();"),
        ("  const long long stride = (long long)gridDim.x * THREADS;\n  for (long long e = ",
         "  float sink = 0.f;\n  const long long stride = (long long)gridDim.x * THREADS;\n"
         "  for (long long e = "),
        ("      atomicAdd(s_acc + ((size_t)k * S + s) * g + j, v);", "      sink += v + (float)s;")],
    "b14_no_div": [("    const long long i = e / g;", "    const long long i = e >> 3;")],
    "b14_no_flush": [("    if (v != 0.f) atomicAdd(out + i, v);", "    if (v == 1.2345f) out[i] = v;")],
}

_MERGE_GATHER = """        const float4 v =
            *reinterpret_cast<const float4*>(s_cb + (k * S + code_of(cw[u], k)) * g + col);"""
_CODE_BYTES = """  const int code_bytes =
      (K == 1 || K == 2 || K == 4 || K == 8) && reinterpret_cast<uintptr_t>(codes) % K == 0 ? K : 0;"""
_MERGE_NO_GATHER = (_MERGE_GATHER, """        const float4 v = make_float4((float)code_of(cw[u], k), 0.f, 0.f, 0.f);""")
_PAIR_ADD = """              atomicAdd(p + sw, kPrecise ? v[u].x : round_bf16(v[u].x));
              atomicAdd(p + (sw ^ 1), kPrecise ? v[u].y : round_bf16(v[u].y));"""
_SINK_DECL = ("  float* s_mine = s_acc + (tr % slots) * g;  // this thread's copy",
              "  float* s_mine = s_acc + (tr % slots) * g;  // this thread's copy\n  float sink = 0.f;")
_SINK_USE = ("  __syncthreads();\n  float* d = dst + (size_t)blockIdx.x * n_acc;",
             "  if (sink == 1.2345f) s_acc[0] = sink;\n  __syncthreads();\n"
             "  float* d = dst + (size_t)blockIdx.x * n_acc;")
MERGE = {
    "full": [],
    "b13_no_gather": [_MERGE_NO_GATHER],
    "b13_stores_only": [_MERGE_NO_GATHER, (
        "      cw[u] = f < n4 ? load_codes<kCodeBytes>(codes + (size_t)n[u] * K, K) : 0;",
        "      cw[u] = f;")],
    "b13_occupancy8": [("""template <bool kPrecise, int kCodeBytes>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant4_kernel(""", """template <bool kPrecise, int kCodeBytes>
__global__ void __launch_bounds__(DQ_THREADS, 8)
    dequant4_kernel(""")],
    "b13_units2": [("constexpr int DQ_UNITS = 4;", "constexpr int DQ_UNITS = 2;")],
    "b13_codes_l2": [(
        "      cw[u] = f < n4 ? load_codes<kCodeBytes>(codes + (size_t)n[u] * K, K) : 0;",
        "      cw[u] = f < n4 ? load_codes<kCodeBytes>(codes + (size_t)(n[u] & 0xffff) * K, K) : 0;")],
    "b13_byte_codes": [(_CODE_BYTES + "\n  const FastDiv per_group", "  const int code_bytes = 0;\n  const FastDiv per_group")],
    "b14_byte_codes": [(_CODE_BYTES + "\n  switch", "  const int code_bytes = 0;\n  switch")],
    "b13_b14_byte_loads": [("    return __ldg(reinterpret_cast<const unsigned short*>(p));",
                            "    return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8);")],
    "b14_loads_only": [_SINK_DECL, _SINK_USE, (
        _PAIR_ADD, "              sink += (v[u].x + v[u].y) * (float)(code_of(cw[u], k) + 1) + (float)(p - s_acc);")],
    "b14_plain_adds": [(_PAIR_ADD, """              p[sw] += kPrecise ? v[u].x : round_bf16(v[u].x);
              p[sw ^ 1] += kPrecise ? v[u].y : round_bf16(v[u].y);""")],
    "b14_unroll4": [("constexpr int CG_UNROLL = 8;", "constexpr int CG_UNROLL = 4;")],
    "b14_unroll12": [("constexpr int CG_UNROLL = 8;", "constexpr int CG_UNROLL = 12;")],
    "b14_unroll16": [("constexpr int CG_UNROLL = 8;", "constexpr int CG_UNROLL = 16;")],
    "b14_l2_prefetch": [(
        "      for (long long i0 = g0 + tr; i0 < g1; i0 += batch) {",
        "      for (long long i0 = g0 + tr; i0 < g1; i0 += batch) {\n"
        "        if (threadIdx.x == 0 && i0 + 2 * batch < g1) {\n"
        "          const long long p0 = i0 + 2 * batch, p1 = min(g1, p0 + batch);\n"
        "          asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"(data + p0 * g),\n"
        "                       \"r\"((int)((p1 - p0) * g * 4) & ~15) : \"memory\");\n"
        "        }")],
    "b14_floats": [],  # runtime: a float a thread (4 bank-interleaved copies, 32-bit atomics)
    "b14_one_copy": [],  # runtime: one shared copy a block
    "b14_no_merge": [("  cb_grad_merge_kernel<<<", "  if (n_acc < 0) cb_grad_merge_kernel<<<")],
}
PATCHES = MERGE if DESIGN == "merge" else ATOMIC
if len(sys.argv) > 3:
    PATCHES = {v: PATCHES[v] for v in sys.argv[3].split(",")}

CEILING_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512) write4(float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * 512ll + threadIdx.x; i < n4; i += (long long)gridDim.x * 512)
    out[i] = make_float4((float)i, 1.f, 2.f, 3.f);
}
__global__ void __launch_bounds__(512) read4(const float4* __restrict__ in, long long n4,
                                             float* __restrict__ sink) {
  float acc = 0.f;
  long long i = blockIdx.x * 512ll + threadIdx.x;
  const long long step = (long long)gridDim.x * 512;
  for (; i + 3 * step < n4; i += 4 * step) {
    const float4 a = __ldg(in + i), b = __ldg(in + i + step), c = __ldg(in + i + 2 * step),
                 d = __ldg(in + i + 3 * step);
    acc += a.x + b.y + c.z + d.w;
  }
  for (; i < n4; i += step) acc += __ldg(in + i).x;
  if (acc == 1.2345f) *sink = acc;
}
extern "C" int ceiling_launch(int write, void* p, long long n4, void* sink, int blocks, void* st) {
  if (write) write4<<<blocks, 512, 0, (cudaStream_t)st>>>((float4*)p, n4);
  else read4<<<blocks, 512, 0, (cudaStream_t)st>>>((const float4*)p, n4, (float*)sink);
  return cudaGetLastError();
}
"""


def nvcc(src_dir, cu, out_dir, keep_log=None):
    """Build one .cu (with csrc's headers) into out_dir/lib.so; the ptxas
    report to keep_log."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "lib.so")
    r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I", src_dir, cu, "-o",
                        lib], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {cu} failed:\n{r.stdout}\n{r.stderr}")
    if keep_log:
        with open(keep_log, "w") as f:
            f.write(r.stdout + r.stderr)
    return lib


def build_variant(variant, patches):
    d = os.path.join(BUILD, f"{DESIGN}_{variant}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, name), d)
    text = CU
    for old, new in patches:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)
    cu = os.path.join(d, "calib_dequant.cu")
    with open(cu, "w") as f:
        f.write(text)
    log = os.path.join("chiprun_out", f"ptxas_b13_b14_{DESIGN}.txt") if variant == "full" else None
    lib = ctypes.CDLL(nvcc(d, cu, d, log))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.calib_dequant_launch.argtypes = [P] * 4 + [L] + [I] * 5 + [P]
    lib.cb_grad_launch.argtypes = ([P] * 4 + [L] + [I] * 7 + [P] if DESIGN == "merge"
                                   else [P] * 3 + [L] + [I] * 4 + [P])
    lib.calib_dequant_launch.restype = lib.cb_grad_launch.restype = I
    if variant == "full":
        sass = subprocess.run([os.path.join(os.path.dirname(NVCC), "cuobjdump"), "-sass",
                               os.path.join(d, "lib.so")], capture_output=True, text=True).stdout
        with open(os.path.join("chiprun_out", f"sass_b14_{DESIGN}.txt"), "w") as f:
            keep, lines = False, []
            for line in sass.splitlines():
                if "Function :" in line:
                    keep = "cb_grad" in line
                if keep:
                    lines.append(line)
            f.write("\n".join(lines))
        print("SASS atomics in B14:", sorted({w for line in lines for w in line.split()
                                              if w.startswith(("ATOMS", "ATOM.", "RED"))}),
              flush=True)
    return lib


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, DESIGN, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    sys.path.insert(0, SRC)
    from aqlm_tpu_torch.ops import kernels as kn  # the plain versions (and B14's plan)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    st = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    shapes = {}
    for name, out_f, in_f in CALIB_PROJS[:2]:
        ig = in_f // G8
        codes = torch.randint(0, S, (COPIES, out_f, ig, K), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        data = torch.randn((out_f * ig, G8), generator=gen, device=dev)
        shapes[name] = (out_f, in_f, ig, codes, data)
    cb = torch.randn((K, S, G8), generator=gen, device=dev) / 4
    partials = torch.empty(256 * K * S * G8, device=dev)

    def b13(lib, name, precise):
        out_f, in_f, ig, codes, _ = shapes[name]
        out = torch.empty((out_f, in_f), device=dev)

        def run(i=0):
            rc = lib.calib_dequant_launch(codes[i % COPIES].data_ptr(), cb.data_ptr(), None,
                                          out.data_ptr(), out_f * ig, ig, K, S, G8, int(precise),
                                          st())
            assert rc == 0, rc
            return out
        return run

    def b14(lib, name, precise, variant):
        out_f, in_f, ig, codes, data = shapes[name]
        flat = codes[0].reshape(-1, K)
        G = flat.shape[0]
        out = torch.empty((K, S, G8), device=dev)
        if DESIGN == "merge":
            p = kn.cb_grad_plan(G, K, S, G8, sms, pairs=variant != "b14_floats")
            blocks, slots, vec = p.blocks, 1 if variant == "b14_one_copy" else p.slots, p.vec

        def run(i=0):
            if DESIGN == "merge":
                rc = lib.cb_grad_launch(flat.data_ptr(), data.data_ptr(), out.data_ptr(),
                                        partials.data_ptr(), G, K, S, G8, blocks, slots, vec,
                                        int(precise), st())
            else:
                rc = lib.cb_grad_launch(flat.data_ptr(), data.data_ptr(), out.data_ptr(), G, K, S,
                                        G8, int(precise), st())
            assert rc == 0, rc
            return out
        return run

    bad = 0
    for variant, patches in PATCHES.items():
        lib = build_variant(variant, patches)
        for name, (out_f, in_f, ig, codes, data) in shapes.items():
            w_bytes = out_f * in_f * 4
            for precise in (True, False):
                if variant == "full" or variant.startswith("b13"):
                    run = b13(lib, name, precise)
                    if variant == "full":
                        ok = torch.equal(run(0), kn.dequant_plain(codes[0], cb, precise=precise))
                        bad += not ok
                    ms = time_ms(run, 20, 5)
                    emit({"design": DESIGN, "variant": variant, "kernel": "b13", "proj": name,
                          "precise": precise, "ms": ms, "tb_s": w_bytes / ms / 1e9,
                          "share_of_byte_bound": w_bytes / HBM_BYTES_PER_S * 1e3 / ms,
                          **({"ok": ok} if variant == "full" else {})})
                if variant == "full" or variant.startswith(("b14", "b13_b14")):
                    run = b14(lib, name, precise, variant)
                    if variant == "full":
                        flat = codes[0].reshape(-1, K)
                        d64 = (data if precise else data.to(torch.bfloat16).float()).double()
                        want = torch.zeros((K, S, G8), dtype=torch.float64, device=dev)
                        mass = torch.zeros_like(want)
                        for k in range(K):
                            want[k].index_add_(0, flat[:, k].long(), d64)
                            mass[k].index_add_(0, flat[:, k].long(), d64.abs())
                        ok = bool(((run(0).double() - want).abs() <= 1e-5 * mass).all())
                        bad += not ok
                    ms = time_ms(run, 20, 5)
                    emit({"design": DESIGN, "variant": variant, "kernel": "b14", "proj": name,
                          "precise": precise, "ms": ms, "tb_s": w_bytes / ms / 1e9,
                          "share_of_byte_bound": w_bytes / HBM_BYTES_PER_S * 1e3 / ms,
                          **({"ok": ok} if variant == "full" else {})})
        torch.cuda.empty_cache()

    cl = ctypes.CDLL(nvcc(CSRC, _write_ceiling_src(), os.path.join(BUILD, "ceiling")))
    cl.ceiling_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    sink = torch.zeros(1, device=dev)
    for name, (out_f, in_f, ig, codes, data) in shapes.items():
        w = torch.empty((out_f, in_f), device=dev)
        w_bytes = out_f * in_f * 4
        for variant, fn in (
                ("fill", lambda i=0: w.fill_(1.0)),
                ("write_ceiling", lambda i=0: cl.ceiling_launch(1, w.data_ptr(), w.numel() // 4, None,
                                                                sms * 4, st())),
                ("read_ceiling", lambda i=0: cl.ceiling_launch(0, data.data_ptr(), data.numel() // 4,
                                                               sink.data_ptr(), sms * 4, st()))):
            ms = time_ms(fn, 20, 5)
            emit({"design": DESIGN, "variant": variant, "proj": name, "ms": ms,
                  "tb_s": w_bytes / ms / 1e9, "share_of_byte_bound": w_bytes / HBM_BYTES_PER_S * 1e3 / ms})
        del w
    with open(OUT_JSON, "w") as f:
        json.dump({"nvidia_smi": smi, "source": SRC, "design": DESIGN, "bad": bad,
                   "records": records}, f, indent=1)
    print("bad", bad, flush=True)
    return 1 if bad else 0


def _write_ceiling_src():
    d = os.path.join(BUILD, "ceiling")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "ceiling.cu")
    with open(path, "w") as f:
        f.write(CEILING_SRC)
    return path


if __name__ == "__main__":
    sys.exit(main())
