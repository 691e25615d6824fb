"""What bounds K2 on the card: time copies of this checkout's K2 with one
role of its pipeline switched off, in one process on one card.

    python3 experiments/torch_k2_ablate.py [OUT_JSON] [PARENT]

Each variant is this checkout's ``aqlm_tpu_torch`` copied under
``build/k2_ablate/<variant>/`` with ``csrc/gather_prefill.cu`` patched (the
checkout's source is not touched), built into that copy's build directory
and imported in turn (the modules of each stay bound to their own library):

- ``full``: the kernel as it is;
- ``no_dequant``: the dequantiser warps only wait and arrive (W^T stays
  whatever shared memory held);
- ``no_mma``: the consumer warpgroups only wait and release (no wgmma);
- ``no_x``: the producer copies the code slabs but not the activation tiles;
- ``mma_only``: no dequantisation and no activation loads.

With PARENT (a directory holding an older ``aqlm_tpu_torch``, e.g. the
parent commit's, unpacked with ``git archive``), that K2 is ablated too:
``parent`` as it is, ``parent_no_dequant`` (its slab dequantisation loop
skipped), ``parent_no_mma`` (its WMMA loop skipped) and ``parent_no_x`` (its
activation copies skipped); its three block-wide syncs a slab stay.

The variants' outputs are meaningless; only their times are read. Times are
chip_smoke.time_ms (CUDA-graph replays) at Llama-2-7B's fused qkv (T=64,
256, 1024), Falcon-7B's fc1 (T=1024) and Mixtral-8x7B's all-expert gate/up
(T=1024, f32). Prints one JSON line per variant and shape and writes all to
OUT_JSON (default chiprun_out/k2_ablate.json).
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import _proj_inputs, time_ms  # noqa: E402

SRC = "aqlm_tpu_torch/ops/csrc/gather_prefill.cu"
PATCHES = {
    "full": [],
    "no_dequant": [("      if (K <= 2) {", "      if (true) {\n      } else if (K <= 2) {")],
    "no_mma": [("      if (active) {", "      if (false) {")],
    "no_x": [("      if (lane == 0) {\n        mbar_arrive_expect_tx",
              "      if (false) {\n        mbar_arrive_expect_tx"),
             ("mbar_init(full + i, 33);", "mbar_init(full + i, 32);")],
}
PATCHES["mma_only"] = PATCHES["no_dequant"] + PATCHES["no_x"]
PARENT_PATCHES = {
    "parent": [],
    "parent_no_dequant": [("    for (int i = tid; i < (BK / G) * BN; i += THREADS) {",
                           "    for (int i = tid; i < 0; i += THREADS) {")],
    "parent_no_mma": [("    for (int kk = 0; kk < BK; kk += 16) {",
                       "    for (int kk = 0; kk < 0; kk += 16) {")],
    "parent_no_x": [("    for (int i = tid; i < BM * (BK / 8); i += THREADS) {",
                     "    for (int i = tid; i < 0; i += THREADS) {")],
}
out_json = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out", "k2_ablate.json")
parent = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else None
VARIANTS = [(v, ROOT, p) for v, p in PATCHES.items()]
if parent:
    VARIANTS += [(v, parent, p) for v, p in PARENT_PATCHES.items()]

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "k2_ablate")
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
    from aqlm_tpu_torch.ops import gather_prefill as gp  # noqa: E402
    from aqlm_tpu_torch.ops import lut_gemv as lg  # noqa: E402
    assert gp.__file__.startswith(root), gp.__file__
    gp._build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for proj, sizes, in_f, rows_list in [("qkv", (4096, 4096, 4096), 4096, (64, 256, 1024)),
                                             ("falcon_fc1", (18176,), 4544, (1024,))]:
            codes, cb, scales, pm, _ = _proj_inputs(gen, sizes, in_f, dev)
            for rows in rows_list:
                x = torch.randn((8, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
                ms = time_ms(lambda i=0: gp.launch(x[i % 8], codes[i % 8], cb[i % 8], scales[i % 8],
                                                   pm, 8), 10, 5)
                rec = {"variant": variant, "proj": proj, "rows": rows, "ms": ms}
                records.append(rec)
                print(json.dumps(rec), flush=True)
            del codes, cb, scales
        E, out_f, in_f, rows = 8, 14336, 4096, 1024
        codes = torch.randint(0, 256, (2, E, out_f // 512, in_f // 4, 512), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((2, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((2, E, out_f), generator=gen, device=dev) + 0.5
        x = torch.randn((2, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
        ms = time_ms(lambda i=0: lg.moe_prefill_launch(x[i % 2], codes[i % 2], cb[i % 2],
                                                       scales[i % 2], 8), 3, 5)
        rec = {"variant": variant, "proj": "mixtral_gate_up", "experts": E, "rows": rows, "ms": ms}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del codes, cb, scales, x
        torch.cuda.empty_cache()
    sys.path.remove(root)

os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
