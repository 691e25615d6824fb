"""What sets the int4 (W4A16) decode GEMV's floor on the card: time copies of
one package's GEMV with one part of its work switched off, in one process on
one card.

    python3 experiments/torch_int4_gemv_ablate.py ROOT [OUT_JSON]

ROOT holds the ``aqlm_tpu_torch`` package to ablate (``.`` for this
checkout; ``build/parent`` for the parent commit's package, unpacked with
``git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent``). The patches
fit the first design's split-contraction GEMV (``int4_gemv_kernel`` in
``csrc/int4_matmul.cu`` with its ``torch.zeros`` tickets): each variant is
the package copied under ``build/int4_gemv_ablate/<variant>/`` with one patch
(the sources under ROOT are not touched), built into that copy's build
directory and imported in turn:

- ``full``: the kernel as it is;
- ``no_x``: the activations are not loaded (a constant takes their place);
- ``no_mma``: no ``mma.sync`` (its operands are folded into the group sum
  by an xor, so the loads and the widening stay);
- ``no_fixup``: a split block writes its sums to the output instead of the
  partials, the fence and the ticket (the output races: only time counts);
- ``splits1``: the plan never splits the contraction (no partials, no
  ticket, no ``torch.zeros``; half the blocks at o and down);
- ``empty``: the kernel returns at once (the launch and its ticket fill).

Beside them, ``zeros``: the wrapper's ``torch.zeros`` of the tickets timed
alone, and ``library``: ``torch._weight_int4pack_mm`` on the same weights.
The variants' outputs are meaningless; only their times are read. Times are
chip_smoke.time_ms (CUDA-graph replays, median of 5) over 8 stacked copies,
at Llama-2-7B's o, down, fused qkv and fused gate/up, B=1 and B=4. Prints
one JSON line per variant and shape and writes all to OUT_JSON (default
chiprun_out/int4_gemv_ablate.json), with the full copy's ptxas report.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import INT4_PROJS, _int4_library, time_ms  # noqa: E402

SRC = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "int4_gemv_ablate.json")
CU = "aqlm_tpu_torch/ops/csrc/int4_matmul.cu"
PY = "aqlm_tpu_torch/ops/int4_matmul.py"
PATCHES = {
    "full": [],
    "no_x": [(CU, "(xrow && c < k_end) ? __ldg(reinterpret_cast<const uint2*>(xr + c))\n"
                  "                                               : make_uint2(0, 0);",
              "make_uint2((uint32_t)c, 0x3f803f80u);")],
    "no_mma": [(CU, "          mma_bf16_16816(g, a, xv.x, xv.y);",
                "          g[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ xv.x ^ xv.y) & 0x7fffffu);")],
    "no_fixup": [(CU, "  if (gridDim.y == 1) {", "  if (true) {")],
    "splits1": [(PY, "        splits = _splits(experts * blocks, n_units, sm_count, max(1, n_units // 8))",
                 "        splits = 1")],
    "empty": [(CU, "  __shared__ int s_last;\n", "  __shared__ int s_last;\n  if (T > 0) return;\n")],
}

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "int4_gemv_ablate")
L, ROWS = 8, (1, 4)
os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)


def emit(rec):
    records.append(rec)
    print(json.dumps(rec), flush=True)


gen = torch.Generator(device=dev).manual_seed(0)
weights = {}
for name, out_f, in_f in INT4_PROJS:
    ldb = -(-in_f // 1024) * 1024 // 2 if in_f > 1024 else -(-in_f // 256) * 128
    w = torch.randint(0, 256, (L, out_f, ldb), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    s = torch.rand((L, ldb // 64, out_f), generator=gen, device=dev) / 64
    xs = {rows: torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
          for rows in ROWS}
    weights[name] = (w, s, xs, out_f, in_f)

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
    from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402
    assert i4.__file__.startswith(root), i4.__file__
    i4._build.library()
    if variant == "full":
        log = os.path.join(i4._build.BUILD_DIR, "int4_matmul.o.log")
        with open(log) as f, open(os.path.join("chiprun_out", "ptxas_int4_ablate.txt"), "w") as g:
            g.write(f.read())
    with torch.inference_mode():
        for name, (w, s, xs, out_f, in_f) in weights.items():
            for rows in ROWS:
                x = xs[rows]
                p = i4.plan(rows, out_f, in_f, w.shape[-1], 1, 132)
                ms = time_ms(lambda i=0: i4.launch(x[i % L], w[i % L], s[i % L]), 50, 5)
                emit({"variant": variant, "proj": name, "rows": rows, "ms": ms,
                      "splits": p.splits, "blocks": p.grid[0] * p.grid[1]})
                if variant == "full":
                    n = p.n_tickets(1) if p.splits > 1 else 0
                    if n:
                        zms = time_ms(lambda i=0: torch.zeros(n, dtype=torch.int32, device=dev), 50, 5)
                        emit({"variant": "zeros", "proj": name, "rows": rows, "ms": zms,
                              "tickets": n})
    sys.path.remove(root)

with torch.inference_mode():  # the library call on the same q and scales, for the record
    from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402
    for name, (w, s, xs, out_f, in_f) in weights.items():
        lib = [_int4_library(w[i], s[i], in_f) for i in range(L)]
        for rows in ROWS:
            x = xs[rows]
            ms = time_ms(lambda i=0: torch._weight_int4pack_mm(
                x[i % L], lib[i % L][0], i4.GROUP, lib[i % L][1]), 50, 5)
            emit({"variant": "library", "proj": name, "rows": rows, "ms": ms})
        del lib
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "source": SRC, "records": records}, f, indent=1)
