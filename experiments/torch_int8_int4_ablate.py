"""What bounds the int8 and int4 prefill GEMMs on the card: time copies of
them with one part of their work switched off, in one process on one card.

    python3 experiments/torch_int8_int4_ablate.py [OUT_JSON]

Each variant is an ``aqlm_tpu_torch`` copied under
``build/int8_int4_ablate/<variant>/`` with ``csrc/int8_matmul.cu`` and
``csrc/int4_matmul.cu`` patched (the checkout's sources are not touched),
built into that copy's build directory and imported in turn (the modules of
each stay bound to their own library):

- ``full``: the kernels as they are;
- ``no_dequant``: the widening (int8) and unpacking (int4) warps skip their
  work (the products read whatever the W^T buffers hold), still keeping
  every barrier;
- ``no_mma``: the consumers issue no wgmma (they still wait on every
  barrier, fold and write the output);
- ``no_fold``: int4 only: the consumers do not fold the group sums in.

The variants' outputs are meaningless; only their times are read. Times are
chip_smoke.time_ms (CUDA-graph replays) at Llama-2-7B's fused qkv (T=1024)
and down (T=64, a split contraction), and Mixtral-8x7B's all-expert gate/up
(T=1024, shared x). Prints one JSON line per variant and shape and writes
all to OUT_JSON (default chiprun_out/int8_int4_ablate.json).
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import time_ms  # noqa: E402

INT8 = "aqlm_tpu_torch/ops/csrc/int8_matmul.cu"
INT4 = "aqlm_tpu_torch/ops/csrc/int4_matmul.cu"
WIDEN = ("      widen_slab(smem + L.w8(st), smem + L.bt(wb), dt);  // widen\n", "")
UNPACK = ("      unpack_slab(smem + L.w4(ws), smem + L.bt(wb), dt, jj);  // unpack\n", "")
PATCHES = {
    "full": [],
    "no_dequant": [(INT8, *WIDEN), (INT4, *UNPACK)],
    "no_mma": [(INT8, "      if (active) {  // the slab's products",
                "      if (false) {  // the slab's products"),
               (INT4, "        if (active) {  // the slab's products",
                "        if (false) {  // the slab's products")],
    "no_fold": [(INT4, "      if (active) {\n        const float* s =",
                 "      if (false) {\n        const float* s =")],
}
out_json = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out", "int8_int4_ablate.json")

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "int8_int4_ablate")
# (kernel, proj, E, OUT, IN, rows)
SHAPES = [("int8", "qkv", 1, 12288, 4096, 1024), ("int8", "down", 1, 4096, 11008, 64),
          ("int8", "mixtral_gate_up", 8, 14336, 4096, 1024),
          ("int4", "qkv", 1, 12288, 4096, 1024), ("int4", "down", 1, 4096, 11008, 64),
          ("int4", "mixtral_gate_up", 8, 14336, 4096, 1024)]
for variant, patches in PATCHES.items():
    root = os.path.join(base, variant)
    shutil.rmtree(os.path.join(root, "aqlm_tpu_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "aqlm_tpu_torch"), os.path.join(root, "aqlm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in patches:
        path = os.path.join(root, src)
        text = open(path).read()
        assert text.count(old) == 1, (variant, old)
        open(path, "w").write(text.replace(old, new))
    for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402
    from aqlm_tpu_torch.ops import int8_matmul as im  # noqa: E402
    assert im.__file__.startswith(root), im.__file__
    im._build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for kernel, proj, E, out_f, in_f, rows in SHAPES:
            if kernel == "int8" and variant == "no_fold":
                continue
            L = 2 if E > 1 else 8  # stacked copies cycled, so the weights come from HBM
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            if kernel == "int8":
                w = torch.randint(-127, 128, (L, E, out_f, im.pad_in_features(in_f)),
                                  generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
                s = torch.rand((L, E, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
                fn = im.moe_launch if E > 1 else lambda a, b, c: im.launch(a, b[0], c[0])
            else:
                w = torch.randint(0, 256, (L, E, out_f, i4.pad_in_features_int4(in_f) // 2),
                                  generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
                s = torch.rand((L, E, w.shape[-1] // 64, out_f), generator=gen, device=dev) / 64
                fn = i4.moe_launch if E > 1 else lambda a, b, c: i4.launch(a, b[0], c[0])
            ms = time_ms(lambda i=0: fn(x[i % L], w[i % L], s[i % L]), 3 if E > 1 else 20, 5)
            rec = {"variant": variant, "kernel": kernel, "proj": proj, "experts": E, "rows": rows,
                   "ms": ms}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            del w, s, x
            torch.cuda.empty_cache()
    sys.path.remove(root)

os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
