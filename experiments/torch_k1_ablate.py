"""What bounds K1 on the card: time copies of K1 with one part of its work
switched off, in one process on one card.

    python3 experiments/torch_k1_ablate.py [OUT_JSON] [PARENT] [--parent-only]

Each variant is an ``aqlm_tpu_torch`` copied under ``build/k1_ablate/<variant>/``
with ``csrc/lut_gemv.cu`` patched (the checkout's source is not touched),
built into that copy's build directory and imported in turn (the modules of
each stay bound to their own library). This checkout's K1 (per-block
shared-memory tables):

- ``full``: the kernel as it is;
- ``no_build``: the tables are not built (the lookups read whatever shared
  memory holds);
- ``no_lookup``: the tables are built and the codes streamed, but not looked up;
- ``no_codes``: no code is copied (the lookups read whatever the ring holds:
  equal codes, whose lanes' reads merge, so it also shows the lookups'
  shared-memory traffic);
- ``no_sync``: the block-wide barrier of each chunk left out (a race: the
  time of the work without its waits).

With PARENT (a directory holding an older ``aqlm_tpu_torch``, e.g. the
parent commit's, unpacked with ``git archive``), that K1 (a lane sums its
columns' codebook vectors from shared memory, then takes dot products with
x) is ablated too: ``parent`` as it is, ``parent_no_lookup`` (the codebook
reads replaced by the code word itself: no shared-memory lookups) and
``parent_no_fma`` (x not read and the B x 32 FMAs a group replaced by 32
adds). ``--parent-only`` times the parent's variants alone.

The variants' outputs are meaningless; only their times are read. Times are
chip_smoke.time_ms (CUDA-graph replays) at Llama-2-7B's fused qkv and down
(B=4) and Mixtral-8x7B's all-expert gate/up (B=1, 4, 8). Prints one JSON line
per variant and shape and writes all to OUT_JSON (default
chiprun_out/k1_ablate.json).
"""
import json
import math
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import _proj_inputs, time_ms  # noqa: E402

SRC = "aqlm_tpu_torch/ops/csrc/lut_gemv.cu"
PATCHES = {
    "full": [],
    "no_build": [("  if (n_chunks > 0) build(0, xa, s_tab);", "  if (false) build(0, xa, s_tab);"),
                 ("    if (c + 1 < n_chunks) build(", "    if (false) build(")],
    "no_lookup": [("    lookups(s_tab + (c & 1)", "    if (false) lookups(s_tab + (c & 1)")],
    "no_codes": [("    if (cn < n_chunks) load_codes(cn, cn % stages);",
                  "    if (false) load_codes(cn, cn % stages);"),
                 ("    if (c < n_chunks) load_codes(c, c);", "    if (false) load_codes(c, c);")],
    "no_sync": [("    __syncthreads();  // everyone's; chunk c's tables", "    // everyone's; chunk c's tables")],
}
PARENT_PATCHES = {
    "parent": [],
    "parent_no_lookup": [("aqlm::bf16x8_to_float(s_cb[k * S + ((c4 >> (8 * j)) & 0xff)], f);",
                          "aqlm::bf16x8_to_float(make_uint4(c4, c4 >> 8, c4 >> 16, c4 >> 24), f);")],
    "parent_no_fma": [("""      for (int b = 0; b < B; ++b) {
        float xv[G];
        aqlm::load8(x + (size_t)b * in_features + ig * G, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < G; ++e) acc[b][j] = fmaf(xv[e], w[j][e], acc[b][j]);
      }""", """      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < G; ++e) acc[0][j] += w[j][e];""")],
}
args = [a for a in sys.argv[1:] if not a.startswith("--")]
out_json = args[0] if args else os.path.join("chiprun_out", "k1_ablate.json")
parent = os.path.abspath(args[1]) if len(args) > 1 else None
VARIANTS = [] if "--parent-only" in sys.argv else [(v, ROOT, p) for v, p in PATCHES.items()]
if parent:
    VARIANTS += [(v, parent, p) for v, p in PARENT_PATCHES.items()]

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "k1_ablate")
for variant, src_root, patches in VARIANTS:
    root = os.path.join(base, variant)
    shutil.rmtree(os.path.join(root, "aqlm_tpu_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(src_root, "aqlm_tpu_torch"), os.path.join(root, "aqlm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SRC)
    text = open(path).read()
    for old, new in patches:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)
    open(path, "w").write(text)
    for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    from aqlm_tpu_torch.ops import lut_gemv as lg  # noqa: E402
    assert lg.__file__.startswith(root), lg.__file__
    lg._build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for proj, sizes, in_f in [("qkv", (4096, 4096, 4096), 4096), ("down", (4096,), 11008)]:
            codes, cb, scales, pm, _ = _proj_inputs(gen, sizes, in_f, dev)
            x = torch.randn((8, 4, in_f), generator=gen, device=dev).to(torch.bfloat16)
            kw = {} if variant.startswith("parent") else {"proj_cols": math.gcd(*sizes)}
            ms = time_ms(lambda i=0: lg.launch(x[i % 8], codes[i % 8], cb[i % 8], scales[i % 8], pm,
                                               torch.bfloat16, 8, **kw), 50, 5)
            rec = {"variant": variant, "proj": proj, "rows": 4, "ms": ms}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            del codes, cb, scales
        E, out_f, in_f = 8, 14336, 4096
        codes = torch.randint(0, 256, (2, E, out_f // 512, in_f // 4, 512), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((2, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((2, E, out_f), generator=gen, device=dev) + 0.5
        for rows in (1, 4, 8):
            x = torch.randn((2, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            ms = time_ms(lambda i=0: lg.moe_launch(x[i % 2], codes[i % 2], cb[i % 2],
                                                   scales[i % 2], 8), 20, 5)
            rec = {"variant": variant, "proj": "mixtral_gate_up", "experts": E, "rows": rows,
                   "ms": ms}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        del codes, cb, scales, x
        torch.cuda.empty_cache()
    sys.path.remove(root)

os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
