"""What B5 (the dense W^T of the codes-mode backward) and B8 (the in-place KV
row write) spend their time on, on the card: time copies of one package's
``csrc/gather_dequant_wt.cu`` and ``csrc/kv_write.cu`` with one part of their
work switched off, beside the card's write ceiling and the floor of one
CUDA-graph kernel node, in one process on one card.

    python3 experiments/torch_b5_b8_ablate.py ROOT [OUT_JSON] [VARIANT,...]

ROOT holds the ``aqlm_tpu_torch`` package whose sources are ablated (``.``
for this checkout; ``build/parent`` for a parent commit's package, unpacked
with ``git archive <commit> aqlm_tpu_torch | tar -x -C build/parent``). Each
variant is one source with its patches, built alone by nvcc into
``build/b5_b8_ablate/<design>_<variant>/`` and called through ctypes (ROOT's
files are not touched). The designs are told apart by what the sources hold.

B5, the first design (``column``: a thread one output column over a run of
32 input groups, 128-thread blocks, 64-byte warp stores in bf16) and the
second (``runs``: a warp a unit of one input group by 256 columns, a lane
one or two 16-byte runs of a row, 512-byte warp stores, two 8-warp blocks an
SM):

- ``b5_stores_only``: no code loads and no codebook gathers (values made
  from the group and column take their place): the stores alone, in the
  design's lane mapping;
- ``b5_no_gather``: the codes are loaded, the gathers are not (a value made
  from the code takes the entry's place);
- ``b5_codes_l2``: every unit reads the codes of its tile's first 8 input
  groups only, which stay in L2: no code bytes from device memory;
- (``runs`` only) ``b5_no_prefetch``: the next unit's codes are not loaded
  ahead; ``b5_occupancy1``: one block an SM, not two.

B8, the first design (``row_blocks``: a one-warp block per (b, h), plane by
plane) and the second (``loads_first``: a 128-thread block per 128 words of
the widest plane, every load before any store):

- (``loads_first`` only) ``b8_plane_order``: each plane's word stored right
  after its load, through plain (coherent) loads, so each plane's load waits
  behind the previous plane's store, as in the first design.

``full`` is a source as it is. Beside them: ``fill`` (one ``fill_`` of W^T:
the card's write ceiling as PyTorch reaches it) and ``launch_floor`` (a
one-element ``fill_``: the floor of one kernel node of a CUDA graph).
Variants' outputs are meaningless; only their times are read (but ``full``
is held against the plain versions, bit-identical).

Times are chip_smoke.time_ms (CUDA-graph replays of 20 calls for B5, 50 for
B8, median of 5): B5 at Llama-2-7B's q, gate and down (2x8, cycling 8 copies
of the codes; the tiled layout's width, 512 at q, 128 at gate and down) and
at q in 128-wide tiles (``q_tn128``), bf16 and f32 out; B8 at the int8_short cache
[32, 4, 32, 2048, 128], offsets 0/511/512/1999, the int8 form (k, v and both
f32 scale planes) and the bf16 form (one plane), cycling the 32 layers.
Prints one JSON line per variant, shape and form and writes all to OUT_JSON
(default chiprun_out/b5_b8_ablate.json), with each design's ptxas report
(``chiprun_out/ptxas_b5_<design>.txt``, ``ptxas_b8_<design>.txt``).
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

from chip_smoke import BWD_PROJS, HBM_BYTES_PER_S, N_LAYERS_TIMED, time_ms  # noqa: E402

SRC = os.path.abspath(sys.argv[1])
OUT_JSON = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "b5_b8_ablate.json")
CSRC = os.path.join(SRC, "aqlm_tpu_torch", "ops", "csrc")
B5_CU = open(os.path.join(CSRC, "gather_dequant_wt.cu")).read()
B8_CU = open(os.path.join(CSRC, "kv_write.cu")).read()
B5_DESIGN = "runs" if "WT_COLS" in B5_CU else "column"
B8_DESIGN = "loads_first" if "KV_THREADS" in B8_CU else "row_blocks"
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
BUILD = os.path.join(HERE, "build", "b5_b8_ablate")

_COL_FIRST = """    float acc[G];
    aqlm::bf16x8_to_float(s_cb[__ldg(row)], acc);"""
_COL_NEXT = "      aqlm::bf16x8_to_float(s_cb[k * S + __ldg(row + (size_t)k * tn)], f);"
_COL_ROW = "    const uint8_t* row = cp + (size_t)ig * K * tn;"
COLUMN = {
    "full": [],
    "b5_stores_only": [(_COL_FIRST + "\n    for (int k = 1; k < K; ++k) {", """    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = (float)(ig + j);
    for (int k = 1; k < 0; ++k) {""")],
    "b5_no_gather": [
        (_COL_FIRST, """    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = (float)__ldg(row) + j;"""),
        (_COL_NEXT, """#pragma unroll
      for (int j = 0; j < G; ++j) f[j] = (float)__ldg(row + (size_t)k * tn);""")],
    "b5_codes_l2": [(_COL_ROW, "    const uint8_t* row = cp + (size_t)(ig & 7) * K * tn;")],
}

_RUNS_LOAD = "        cw[r][k] = o < out_features ? load_run<RUN>(p + (size_t)k * tn, codes_aligned) : 0;"
_RUNS_FIRST = "        aqlm::bf16x8_to_float(s_cb[(cw[r][0] >> (8 * i)) & 0xff], acc[i]);"
_RUNS_NEXT = "          aqlm::bf16x8_to_float(s_cb[k * S + ((cw[r][k] >> (8 * i)) & 0xff)], f);"
_RUNS_NO_GATHER = [
    (_RUNS_FIRST, """#pragma unroll
        for (int j = 0; j < G; ++j) acc[i][j] = (float)((cw[r][0] >> (8 * i)) & 0xff) + j;"""),
    (_RUNS_NEXT, """#pragma unroll
          for (int j = 0; j < G; ++j) f[j] = (float)((cw[r][k] >> (8 * i)) & 0xff);""")]
RUNS = {
    "full": [],
    "b5_stores_only": [(_RUNS_LOAD, "        cw[r][k] = (Word)((ig + o + k) * 0x01010101u);"),
                       *_RUNS_NO_GATHER],
    "b5_no_gather": _RUNS_NO_GATHER,
    "b5_codes_l2": [("""  auto load_unit = [&](int u, Word (&cw)[RUNS][K]) {
    const int ig = u / n_chunks;""", """  auto load_unit = [&](int u, Word (&cw)[RUNS][K]) {
    const int ig = (u / n_chunks) & 7;""")],
    "b5_no_prefetch": [("  constexpr bool kPrefetch = K <= 4;", "  constexpr bool kPrefetch = false;")],
    "b5_occupancy1": [("constexpr int WT_BLOCKS_PER_SM = 2;", "constexpr int WT_BLOCKS_PER_SM = 1;")],
}

ROW_BLOCKS = {"full": []}
LOADS_FIRST = {
    "full": [],
    "b8_plane_order": [
        ("      v[i] = __ldg(reinterpret_cast<const uint4*>(src));",
         "      v[i] = *reinterpret_cast<const uint4*>(src);"),
        ("      v[i].x = __ldg(reinterpret_cast<const unsigned int*>(src));",
         "      v[i].x = *reinterpret_cast<const unsigned int*>(src);"),
        ("      v[i].x = (unsigned char)__ldg(src);\n    }\n  }\n  // then every store\n#pragma unroll\n"
         "  for (int i = 0; i < MAX_PLANES; ++i) {\n    if (off[i] < 0 || off[i] >= S) continue;\n"
         "    const Plane pl = planes.p[i];\n",
         "      v[i].x = (unsigned char)*src;\n    }\n    if (off[i] < 0 || off[i] >= S) continue;\n")],
}

B5_PATCHES = RUNS if B5_DESIGN == "runs" else COLUMN
B8_PATCHES = LOADS_FIRST if B8_DESIGN == "loads_first" else ROW_BLOCKS
if len(sys.argv) > 3:
    keep = set(sys.argv[3].split(","))
    B5_PATCHES = {v: p for v, p in B5_PATCHES.items() if v in keep}
    B8_PATCHES = {v: p for v, p in B8_PATCHES.items() if v in keep}


def build(kernel, design, variant, text, patches):
    """One .cu with its patches, alone, into build/b5_b8_ablate/...: the
    loaded library (the full source's ptxas report kept in chiprun_out)."""
    d = os.path.join(BUILD, f"{kernel}_{design}_{variant}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, name), d)
    for old, new in patches:
        assert text.count(old) == 1, (kernel, variant, old)
        text = text.replace(old, new)
    cu = os.path.join(d, f"{kernel}.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I", d, cu, "-o", lib],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc {cu} failed:\n{r.stdout}\n{r.stderr}")
    if variant == "full":
        with open(os.path.join("chiprun_out", f"ptxas_{kernel}_{design}.txt"), "w") as f:
            f.write(r.stdout + r.stderr)
    lib = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    if kernel == "b5":
        lib.gather_dequant_wt_launch.argtypes = [P] * 4 + [I] * 6 + [P]
        lib.gather_dequant_wt_launch.restype = I
    else:
        lib.kv_write_launch.argtypes = [ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(I), I,
                                        P, I, I, I, P]
        lib.kv_write_launch.restype = I
    return lib


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, B5_DESIGN, B8_DESIGN, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    sys.path.insert(0, SRC)
    from aqlm_tpu_torch.ops import gather_prefill as gp  # the plain versions
    from aqlm_tpu_torch.ops import kv_write as kw
    from aqlm_tpu_torch.ops import lut_gemv as lg
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    records, bad = [], 0

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    # B5: q, gate and down, bf16 and f32; q also in 128-wide tiles (gate's width)
    K, S = 2, 256
    shapes = {}
    for name, out_f, in_f, tn in [(n, o, i, lg.lut_tile_n(o)) for n, o, i in BWD_PROJS] + [
            ("q_tn128", 4096, 4096, 128)]:
        codes = torch.randint(0, S, (N_LAYERS_TIMED, out_f // tn, in_f // 8 * K, tn), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        shapes[name] = (out_f, in_f, tn, codes)
    cb = (torch.randn((K, S, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for variant, patches in B5_PATCHES.items():
        lib = build("b5", B5_DESIGN, variant, B5_CU, patches)
        for name, (out_f, in_f, tn, codes) in shapes.items():
            sc = torch.rand(out_f, generator=gen, device=dev) + 0.5
            for dname, dt in dtypes.items():
                out = torch.empty((in_f, out_f), dtype=dt, device=dev)

                def run(i=0):
                    c = codes[i % N_LAYERS_TIMED]
                    rc = lib.gather_dequant_wt_launch(c.data_ptr(), cb.data_ptr(), sc.data_ptr(),
                                                      out.data_ptr(), int(dt == torch.bfloat16),
                                                      c.shape[0], c.shape[1], tn, K, S, st())
                    assert rc == 0, rc
                    return out
                rec = {"kernel": "b5", "design": B5_DESIGN, "variant": variant, "proj": name,
                       "out": dname}
                if variant == "full":
                    rec["ok"] = bool(torch.equal(run(0), gp.dequant_wt_plain(codes[0], cb, sc, dt)))
                    bad += not rec["ok"]
                ms = time_ms(run, 20, 5)
                w_bytes = out.numel() * out.element_size()
                emit({**rec, "ms": ms, "write_tb_s": w_bytes / ms / 1e9,
                      "share_of_byte_bound": (w_bytes + codes[0].numel()) / HBM_BYTES_PER_S * 1e3 / ms})
                del out
        torch.cuda.empty_cache()
    for name, (out_f, in_f, tn, codes) in shapes.items():
        for dname, dt in dtypes.items():
            out = torch.empty((in_f, out_f), dtype=dt, device=dev)
            ms = time_ms(lambda i=0: out.fill_(1.0), 20, 5)
            w_bytes = out.numel() * out.element_size()
            emit({"kernel": "b5", "variant": "fill", "proj": name, "out": dname, "ms": ms,
                  "write_tb_s": w_bytes / ms / 1e9})
            del out
    del shapes
    torch.cuda.empty_cache()

    # B8: the int8_short cache, both forms
    L, B, H, S_len, D = 32, 4, 32, 2048, 128
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    forms = {
        "int8": ([torch.randint(-127, 128, (L, B, H, S_len, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
                 + [torch.rand((L, B, H, S_len, 1), generator=gen, device=dev) for _ in range(2)],
                 [torch.randint(-127, 128, (B, H, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
                 + [torch.rand((B, H, 1), generator=gen, device=dev) for _ in range(2)]),
        "bf16": ([torch.randn((L, B, H, S_len, D), generator=gen, device=dev).to(torch.bfloat16)],
                 [torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)]),
    }
    for variant, patches in B8_PATCHES.items():
        lib = build("b8", B8_DESIGN, variant, B8_CU, patches)
        for form, (caches, news) in forms.items():
            n = len(caches)
            P = ctypes.c_void_p
            rbs = (ctypes.c_int * n)(*[c.shape[-1] * c.element_size() for c in caches])
            srcs = (P * n)(*[x.data_ptr() for x in news])
            per_layer = [(P * n)(*[c[li].data_ptr() for c in caches]) for li in range(L)]

            def run(i=0):
                rc = lib.kv_write_launch(per_layer[i % L], srcs, rbs, n, offsets.data_ptr(), B, H,
                                         S_len, st())
                assert rc == 0, rc
            rec = {"kernel": "b8", "design": B8_DESIGN, "variant": variant, "form": form}
            if variant == "full":
                want = [c[5].clone() for c in caches]
                kw.plain(want, news, offsets)
                run(5)
                rec["ok"] = all(torch.equal(c[5], w) for c, w in zip(caches, want))
                bad += not rec["ok"]
            emit({**rec, "ms": time_ms(run, 50, 5)})
    one = torch.zeros(1, device=dev)
    emit({"kernel": "b8", "variant": "launch_floor", "ms": time_ms(lambda i=0: one.fill_(1.0), 50, 5)})

    with open(OUT_JSON, "w") as f:
        json.dump({"nvidia_smi": smi, "source": SRC, "b5_design": B5_DESIGN, "b8_design": B8_DESIGN,
                   "bad": bad, "records": records}, f, indent=1)
    print("bad", bad, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
