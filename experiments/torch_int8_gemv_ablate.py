"""What the int8 (W8A16) decode GEMV spends its time on, on the card: time
copies of one package's GEMV with one part of its work switched off, in one
process on one card.

    python3 experiments/torch_int8_gemv_ablate.py ROOT [OUT_JSON] [VARIANT,...]

ROOT holds the ``aqlm_tpu_torch`` package to ablate (``.`` for this
checkout; ``build/parent`` for a parent commit's package, unpacked with
``git archive <commit> aqlm_tpu_torch | tar -x -C build/parent``). Two
designs have patches, picked by what ROOT's ``csrc/int8_matmul.cu`` holds.

The split design (CUDA-core FMAs against f32 activations staged in
1024-column chunks, the contraction split over blocks at OUT = 4096):

- ``no_x``: the activations are not read back from shared memory (a
  constant takes their place);
- ``no_stage``: no staging of the activations and no block-wide barrier
  around it;
- ``no_fixup``: a split block writes its sums to the output instead of the
  partials, the fence and the ticket (the output races: only time counts);
- ``splits1``: the plan never splits the contraction (no partials, no
  ticket, no ``torch.zeros``; half the blocks at o and down);
- ``empty``: the kernel returns at once.

The tensor-core design (``int8_gemv_launch``; one block an SM, no split;
at 1-2 rows the launch runs the CUDA-core row kernel, which no patch
touches, so its B=1 lines time that kernel as it is):

- ``no_x``: the staged activations are not read (a constant takes their
  place);
- ``no_mma``: no ``mma.sync`` (its operands are folded into a sum by an
  xor, so the loads and the widening stay);
- ``no_widen``: the weight words go to the ``mma`` unwidened;
- ``loads_only``: all three of the above: the weight loads, the staging and
  the tile reductions stay;
- ``item128``, ``item128_stages4``: a warp's ring holds 3 or 4 items of
  128 columns (a copy instruction reads four rows' 128 bytes) instead of 2
  of 256 columns (two rows' 256 bytes);
- ``l2_256``: the weight copies ask L2 to fetch 256 bytes around each
  (``cp.async...L2::256B``);
- ``empty``: the kernel returns at once.

VARIANT,... names the variants to time (default: all). Each variant is
the package copied under ``build/int8_gemv_ablate/<variant>/``
with its patches (ROOT's sources are not touched), built into that copy's
build directory and imported in turn; ``full`` is the kernel as it is.
Beside them, ``zeros``: the split design's ``torch.zeros`` of its tickets
timed alone, and ``library``: ``torch._weight_int8pack_mm`` on the same
weights. The variants' outputs are meaningless; only their times are read.
Times are chip_smoke.time_ms (CUDA-graph replays, median of 5) over 8
stacked copies, at Llama-2-7B's o, down, fused qkv, fused gate/up and
lm_head, B = 1, 4 and 8, and over 2 stacked layers at Mixtral-8x7B's
all-expert gate/up (shared x) and down (per-expert x), B = 1 and 4. Prints one JSON line per variant and shape and
writes all to OUT_JSON (default chiprun_out/int8_gemv_ablate.json), with the
full copy's ptxas report (chiprun_out/ptxas_int8_ablate_<design>.txt).
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import INT8_PROJS, MOE_PROJS, bound, time_ms  # noqa: E402

SRC = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "int8_gemv_ablate.json")
CU = "aqlm_tpu_torch/ops/csrc/int8_matmul.cu"
PY = "aqlm_tpu_torch/ops/int8_matmul.py"
SPLIT = {
    "full": [],
    "no_x": [(CU, "          const float4 v = row[swz(c / 4 + j)];",
              "          const float4 v = make_float4((float)c, (float)j, 1.f, 2.f);")],
    "no_stage": [(CU, "    __syncthreads();  // the previous chunk's readers are done with s_x\n"
                      "    for (int i = tid; i < B * (GV_CHUNK / 8); i += GV_THREADS) {",
                  "    for (int i = tid; i < 0; i += GV_THREADS) {"),
                 (CU, "    __syncthreads();\n    // the next chunk's weights are in flight",
                  "    // the next chunk's weights are in flight")],
    "no_fixup": [(CU, "  if (gridDim.y == 1) {", "  if (true) {")],
    "splits1": [(PY, "        splits = _splits(experts * blocks, n_chunks, sm_count, n_chunks)",
                 "        splits = 1")],
    "empty": [(CU, "  __shared__ int s_last;\n\n  if (MOE) {",
               "  __shared__ int s_last;\n  if (B > 0) return;\n\n  if (MOE) {")],
}
_NO_X = (CU, "        xv[0] = *reinterpret_cast<const uint4*>(xp);\n"
             "        xv[1] = *reinterpret_cast<const uint4*>(xp + 16);",
         "        xv[0] = make_uint4(j, seg, tig, 0x3f803f80u);\n        xv[1] = xv[0];")
_NO_MMA = (CU, "        mma_bf16_16816(acc, a, word_of(xv[s >> 1], 2 * (s & 1)),\n"
               "                       word_of(xv[s >> 1], 2 * (s & 1) + 1));",
           "        acc[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ word_of(xv[s >> 1], 2 * (s & 1))"
           " ^ word_of(xv[s >> 1], 2 * (s & 1) + 1)) & 0x7fffffu);")
_STAGES = "constexpr int GV_STAGES = 2;"
_NO_WIDEN = (CU, "        s8x4_to_bf16x2(word_of(w0, s), a[0], a[2]);\n"
                 "        s8x4_to_bf16x2(word_of(w1, s), a[1], a[3]);",
             "        a[0] = word_of(w0, s);\n        a[2] = a[0] >> 1;\n"
             "        a[1] = word_of(w1, s);\n        a[3] = a[1] >> 1;")
_PY = "_GEMV_ROWS, _GEMV_WARPS, _GEMV_UNIT, _GEMV_STAGES, _GEMV_ITEM = 16, 16, 64, 2, 256"
_ITEM = "constexpr int GV_ITEM = 256;"


def _ring(stages, item):
    """A ring of `stages` items of `item` columns a warp, in the kernel and its plan."""
    return [(CU, _STAGES, _STAGES.replace("2", str(stages))),
            (CU, _ITEM, _ITEM.replace("256", str(item))),
            (PY, _PY, _PY.replace("2, 256", f"{stages}, {item}"))]


def _l2(size):
    """The weight copies ask L2 to fetch `size` bytes around each."""
    return (CU, "  asm volatile(\"cp.async.cg.shared.global [%0]",
            f"  asm volatile(\"cp.async.cg.shared.global.L2::{size}B [%0]")
TENSOR = {
    "full": [],
    "no_x": [_NO_X],
    "no_mma": [_NO_MMA],
    "no_widen": [_NO_WIDEN],
    "loads_only": [_NO_X, _NO_MMA, _NO_WIDEN],
    "item128": _ring(3, 128),
    "item128_stages4": _ring(4, 128),
    "l2_256": [_l2(256)],
    "empty": [(CU, "  extern __shared__ __align__(16) unsigned char smem[];\n"
                   "  const int row_tiles = (out_features + GV_ROWS - 1) / GV_ROWS;\n"
                   "  const int tiles = (MOE ? experts : 1) * row_tiles;\n  const int n_units",
               "  extern __shared__ __align__(16) unsigned char smem[];\n  if (T > 0) return;\n"
               "  const int row_tiles = (out_features + GV_ROWS - 1) / GV_ROWS;\n"
               "  const int tiles = (MOE ? experts : 1) * row_tiles;\n  const int n_units")],
}
design = "tensor" if "int8_gemv_launch" in open(os.path.join(SRC, CU)).read() else "split"
PATCHES = TENSOR if design == "tensor" else SPLIT
if len(sys.argv) > 3:
    PATCHES = {v: PATCHES[v] for v in sys.argv[3].split(",")}

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, design, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "int8_gemv_ablate")
L, ROWS, MOE_ROWS = 8, (1, 4, 8), (1, 4)
os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)


def emit(rec):
    records.append(rec)
    print(json.dumps(rec), flush=True)


def timed(fn, iters):
    """time_ms of fn, or the launch's error where a variant cannot run the
    shape (a ring that leaves no room for the activations)."""
    try:
        return time_ms(fn, iters, 5)
    except RuntimeError as exc:
        return str(exc)


gen = torch.Generator(device=dev).manual_seed(0)
weights = {}
for name, out_f, in_f in INT8_PROJS:
    ld = -(-in_f // 1024) * 1024 if in_f > 1024 else in_f
    w = torch.randint(-127, 128, (L, out_f, ld), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    w[..., in_f:] = 0
    s = torch.rand((L, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
    xs = {rows: torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
          for rows in ROWS}
    weights[name] = (w, s, xs, out_f, in_f)
moe = {}  # Mixtral-8x7B's all-expert gate/up (shared x) and down (per-expert x), 2 layers
for name, E, out_f, in_f, per_expert in MOE_PROJS:
    w = torch.randint(-127, 128, (2, E, out_f, in_f), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand((2, E, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
    xs = {rows: torch.randn((2, E, rows, in_f) if per_expert else (2, rows, in_f), generator=gen,
                            device=dev).to(torch.bfloat16) for rows in MOE_ROWS}
    moe["mixtral_" + name] = (w, s, xs, E, out_f, in_f)

for variant, patches in PATCHES.items():
    root = os.path.join(base, variant)
    shutil.rmtree(os.path.join(root, "aqlm_tpu_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(SRC, "aqlm_tpu_torch"), os.path.join(root, "aqlm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for src, old, new in patches:
        path = os.path.join(root, src)
        text = open(path).read()
        assert text.count(old) == 1, (variant, old)
        open(path, "w").write(text.replace(old, new))
    for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    from aqlm_tpu_torch.ops import int8_matmul as im  # noqa: E402
    assert im.__file__.startswith(root), im.__file__
    im._build.library()
    if variant == "full":
        log = os.path.join(im._build.BUILD_DIR, "int8_matmul.o.log")
        with open(log) as f, open(os.path.join("chiprun_out", f"ptxas_int8_ablate_{design}.txt"),
                                  "w") as g:
            g.write(f.read())
    with torch.inference_mode():
        for name, (w, s, xs, out_f, in_f) in weights.items():
            for rows in ROWS:
                x = xs[rows]
                p = im.plan(rows, out_f, in_f, w.shape[-1], 1, 132)
                ms = timed(lambda i=0: im.launch(x[i % L], w[i % L], s[i % L]), 50)
                b_ms, _ = bound(out_f * in_f + rows * in_f * 2 + rows * out_f * 2 + out_f * 4,
                                2.0 * rows * out_f * in_f)
                emit({"design": design, "variant": variant, "proj": name, "rows": rows, "ms": ms,
                      "bound_ms": b_ms, "plan": repr(p)})
                if variant == "full" and design == "split" and p.splits > 1:
                    n = p.n_tickets(1)
                    zms = time_ms(lambda i=0: torch.zeros(n, dtype=torch.int32, device=dev), 50, 5)
                    emit({"design": design, "variant": "zeros", "proj": name, "rows": rows,
                          "ms": zms, "tickets": n})
        for name, (w, s, xs, E, out_f, in_f) in moe.items():
            for rows in MOE_ROWS:
                x = xs[rows]
                ms = timed(lambda i=0: im.moe_launch(x[i % 2], w[i % 2], s[i % 2]), 20)
                b_ms, _ = bound(E * out_f * in_f + x[0].numel() * 2 + E * rows * out_f * 2
                                + E * out_f * 4, 2.0 * E * rows * out_f * in_f)
                emit({"design": design, "variant": variant, "proj": name, "rows": rows, "ms": ms,
                      "bound_ms": b_ms})
    sys.path.remove(root)

with torch.inference_mode():  # the library call on the same weights, for the record
    for name, (w, s, xs, out_f, in_f) in weights.items():
        wl = w[..., :in_f].contiguous()
        sl = s.to(torch.bfloat16)
        for rows in ROWS:
            x = xs[rows]
            ms = time_ms(lambda i=0: torch._weight_int8pack_mm(x[i % L], wl[i % L], sl[i % L]),
                         50, 5)
            emit({"design": design, "variant": "library", "proj": name, "rows": rows, "ms": ms})
        del wl, sl
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "source": SRC, "design": design, "records": records}, f, indent=1)
