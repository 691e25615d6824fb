"""Time the parent commit's int8 (W8A16) and int4 (W4A16) kernels, dense
and all-expert, against this checkout's, in one process on one card, in
turns (parent, new, new, parent).

    git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent   # once, here
    python3 experiments/torch_int8_int4_ab.py build/parent [OUT_JSON] [int8|int4]

PARENT is a directory holding the parent's ``aqlm_tpu_torch`` package; its
kernels build under PARENT/build/kernels. Both packages are imported into
this process (the parent's second, under the same name: each module keeps
the ``_build`` it was imported with, and each ctypes library resolves its own
symbols). Shapes, at every main-path row count (the decode buckets 1, 2, 4
and 8 and the prefill buckets 64, 256 and 1024 of chip_smoke's serving
runs):

- the int8 kernel at chip_smoke.INT8_PROJS (Llama-2-7B's fused qkv, o,
  fused gate/up, down and the lm_head) and the int4 kernel at INT4_PROJS;
- both all-expert forms at chip_smoke.MOE_PROJS (Mixtral-8x7B's gate/up,
  shared x, and down, per-expert x);
- the int8 kernel at the lora_int8 step's unfused projections (q, gate,
  down) at T=1024.

Each new result is held against its plain version (chip_smoke.compare) and
the parent's; times are chip_smoke.time_ms (CUDA-graph replays, median of
the turns). Prints one JSON line per shape, writes all of them to OUT_JSON
(default chiprun_out/int8_int4_ab.json) and both checkouts' ptxas reports to
chiprun_out/ptxas_new.txt and chiprun_out/ptxas_parent.txt (compare them with
experiments/ptxas_compare.py). Exits non-zero on a mismatch.
"""
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import (INT4_PROJS, INT8_PROJS, MOE_PROJS, bound, compare,  # noqa: E402
                        engine_serve_config, main_path_rows, time_ms)

parent_root = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "int8_int4_ab.json")
ONLY = sys.argv[3] if len(sys.argv) > 3 else None  # time one kernel's shapes alone

import aqlm_tpu_torch.ops.int4_matmul as i4_new  # noqa: E402
import aqlm_tpu_torch.ops.int8_matmul as im_new  # noqa: E402

ROWS = sum(main_path_rows(engine_serve_config("int8")), [])
for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
    del sys.modules[name]
sys.path.insert(0, parent_root)
import aqlm_tpu_torch.ops.int4_matmul as i4_old  # noqa: E402
import aqlm_tpu_torch.ops.int8_matmul as im_old  # noqa: E402

assert im_old.__file__.startswith(parent_root) and im_new.__file__.startswith(ROOT + os.sep)
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
im_new._build.library()
im_old._build.library()
os.makedirs("chiprun_out", exist_ok=True)
for tag, build_dir in (("new", im_new._build.BUILD_DIR), ("parent", im_old._build.BUILD_DIR)):
    with open(os.path.join("chiprun_out", f"ptxas_{tag}.txt"), "w") as f:
        for name in sorted(os.listdir(build_dir)):
            if name.endswith(".log"):
                with open(os.path.join(build_dir, name)) as log:
                    f.write(f"== {name}\n{log.read()}\n")
gen = torch.Generator(device=dev).manual_seed(0)
records, bad = [], 0


def turns(old, new, iters):
    """Device ms of old and new, timed old, new, new, old; medians."""
    t = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        t[which].append(time_ms(old if which == "old" else new, iters, 3))
    return statistics.median(t["old"]), statistics.median(t["new"])


def run_case(kernel, proj, rows, new, old, plain, byts, flops, plan, iters, **extra):
    global bad
    got = new(0)
    cmp = compare(got, plain(0))
    cmp_old = compare(got, old(0))
    old_ms, new_ms = turns(old, new, iters)
    b_ms, b_by = bound(byts, flops)
    rec = {"kernel": kernel, "proj": proj, "rows": rows, **extra, "ok": cmp["ok"],
           "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"], "parent_ms": old_ms,
           "ms": new_ms, "speedup": old_ms / new_ms, "bound_ms": b_ms, "bound_by": b_by,
           "plan": {k: v for k, v in vars(plan).items()}}
    records.append(rec)
    bad += not cmp["ok"]
    print(json.dumps(rec), flush=True)


with torch.inference_mode():
    L = 8  # stacked copies cycled, so the weights come from HBM
    lora = [(f"lora_{n}", o, i, [1024]) for n, o, i in (("q", 4096, 4096), ("gate", 11008, 4096),
                                                        ("down", 4096, 11008))]
    for name, out_f, in_f, rows_list in ([] if ONLY == "int4" else
                                         [(n, o, i, ROWS) for n, o, i in INT8_PROJS] + lora):
        ld = im_new.pad_in_features(in_f)
        w8 = torch.randint(-127, 128, (L, out_f, ld), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        scale = torch.rand((L, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        for rows in rows_list:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run_case("int8_matmul", name, rows,
                     lambda i=0: im_new.launch(x[i % L], w8[i % L], scale[i % L]),
                     lambda i=0: im_old.launch(x[i % L], w8[i % L], scale[i % L]),
                     lambda i=0: im_new.plain(x[0], w8[0], scale[0]),
                     out_f * in_f + rows * in_f * 2 + rows * out_f * 2 + out_f * 4,
                     2.0 * rows * out_f * in_f, im_new.plan(rows, out_f, in_f, ld), 20)
        del w8, scale
        torch.cuda.empty_cache()

    for name, out_f, in_f in ([] if ONLY == "int8" else INT4_PROJS):
        packs = [i4_new.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev)
                                      * in_f ** -0.5) for _ in range(L)]
        w4 = torch.stack([p[0] for p in packs])
        gs = torch.stack([p[1] for p in packs])
        del packs
        for rows in ROWS:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run_case("int4_matmul", name, rows,
                     lambda i=0: i4_new.launch(x[i % L], w4[i % L], gs[i % L]),
                     lambda i=0: i4_old.launch(x[i % L], w4[i % L], gs[i % L]),
                     lambda i=0: i4_new.plain(x[0], w4[0], gs[0]),
                     out_f * in_f // 2 + 4 * out_f * gs.shape[1] + rows * in_f * 2
                     + rows * out_f * 2, 2.0 * rows * out_f * in_f,
                     i4_new.plan(rows, out_f, in_f, w4.shape[-1]), 20)
        del w4, gs
        torch.cuda.empty_cache()

    L = 2  # two stacked layers cycled: one launch reads 235-470 MB, past the 50 MB L2
    for name, E, out_f, in_f, per_expert in ([] if ONLY == "int4" else MOE_PROJS):
        ld = im_new.pad_in_features(in_f)
        w8 = torch.randint(-127, 128, (L, E, out_f, ld), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        scale = torch.rand((L, E, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        for rows in ROWS:
            x = torch.randn((L, E, rows, in_f) if per_expert else (L, rows, in_f), generator=gen,
                            device=dev).to(torch.bfloat16)
            run_case("int8_moe_matmul", name, rows,
                     lambda i=0: im_new.moe_launch(x[i % L], w8[i % L], scale[i % L]),
                     lambda i=0: im_old.moe_launch(x[i % L], w8[i % L], scale[i % L]),
                     lambda i=0: im_new.moe_plain(x[0], w8[0], scale[0]),
                     E * out_f * in_f + x[0].numel() * 2 + E * rows * out_f * 2 + E * out_f * 4,
                     2.0 * E * rows * out_f * in_f, im_new.plan(rows, out_f, in_f, ld, E),
                     10 if rows <= 8 else 3, experts=E,
                     x="per expert" if per_expert else "shared")
        del w8, scale
        torch.cuda.empty_cache()

    for name, E, out_f, in_f, per_expert in ([] if ONLY == "int8" else MOE_PROJS):
        packs = [i4_new.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev)
                                      * in_f ** -0.5) for _ in range(L * E)]
        w4 = torch.stack([p[0] for p in packs]).reshape(L, E, out_f, -1)
        gs = torch.stack([p[1] for p in packs]).reshape(L, E, -1, out_f)
        del packs
        for rows in ROWS:
            x = torch.randn((L, E, rows, in_f) if per_expert else (L, rows, in_f), generator=gen,
                            device=dev).to(torch.bfloat16)
            run_case("int4_moe_matmul", name, rows,
                     lambda i=0: i4_new.moe_launch(x[i % L], w4[i % L], gs[i % L]),
                     lambda i=0: i4_old.moe_launch(x[i % L], w4[i % L], gs[i % L]),
                     lambda i=0: i4_new.moe_plain(x[0], w4[0], gs[0]),
                     E * out_f * in_f // 2 + E * gs.shape[2] * out_f * 4 + x[0].numel() * 2
                     + E * rows * out_f * 2, 2.0 * E * rows * out_f * in_f,
                     i4_new.plan(rows, out_f, in_f, w4.shape[-1], E),
                     10 if rows <= 8 else 3, experts=E,
                     x="per expert" if per_expert else "shared")
        del w4, gs
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
print("bad", bad, flush=True)
sys.exit(1 if bad else 0)
