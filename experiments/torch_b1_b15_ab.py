"""Time the parent commit's B1 (the 1x16 GEMV and GEMM) and B15 (the untiled
Kx8 GEMV and GEMM) against this checkout's, in one process on one card, in
turns (parent, new, new, parent).

    git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent   # once, here
    python3 experiments/torch_b1_b15_ab.py build/parent [OUT_JSON] [b1|b15]

PARENT is a directory holding the parent's ``aqlm_tpu_torch`` package; its
kernels build under PARENT/build/kernels. Both packages are imported into
this process (the parent's second, under the same name: each module keeps
the ``_build`` it was imported with, and each ctypes library resolves its own
symbols). Shapes, at every main-path row count (the decode buckets 1, 2, 4
and 8 and the prefill buckets 64, 256 and 1024 of chip_smoke's serving
runs): B1 at chip_smoke.GATHER16_PROJS (Llama-2-7B's q, gate and down at
g=8 and q at g=16), B15 at chip_smoke.ONEHOT_PROJS (Falcon-7B's q, k, v, o
and fc2, 2x8 codes).

Each new result is held against its plain version (chip_smoke.compare: one
bf16 step for B1, two for B15) and the parent's; times are
chip_smoke.time_ms (CUDA-graph replays, median of the turns) over 8 stacked
copies, so codes come from device memory. Prints one JSON line per shape
(with the new launch's plan), writes all of them to OUT_JSON (default
chiprun_out/b1_b15_ab.json) and both checkouts' ptxas reports to
chiprun_out/ptxas_new.txt and chiprun_out/ptxas_parent.txt (compare them
with experiments/ptxas_compare.py). Exits non-zero on a mismatch.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import (GATHER16_PROJS, N_LAYERS_TIMED, ONEHOT_PROJS, bound, compare,  # noqa: E402
                        engine_serve_config, main_path_rows, time_ms)

parent_root = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "b1_b15_ab.json")
ONLY = sys.argv[3] if len(sys.argv) > 3 else None  # time one kernel's shapes alone

import aqlm_tpu_torch.ops.gather16 as g16_new  # noqa: E402
import aqlm_tpu_torch.ops.kernels as k15_new  # noqa: E402

ROWS_1X16 = sum(main_path_rows(engine_serve_config("codes_1x16")), [])
ROWS_FALCON = sum(main_path_rows(engine_serve_config("falcon_codes")), [])
for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
    del sys.modules[name]
sys.path.insert(0, parent_root)
import aqlm_tpu_torch.ops.gather16 as g16_old  # noqa: E402
import aqlm_tpu_torch.ops.kernels as k15_old  # noqa: E402

assert g16_old.__file__.startswith(parent_root) and g16_new.__file__.startswith(ROOT + os.sep)
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
g16_new._build.library()
g16_old._build.library()
os.makedirs("chiprun_out", exist_ok=True)
for tag, build_dir in (("new", g16_new._build.BUILD_DIR), ("parent", g16_old._build.BUILD_DIR)):
    with open(os.path.join("chiprun_out", f"ptxas_{tag}.txt"), "w") as f:
        for name in sorted(os.listdir(build_dir)):
            if name.endswith(".log"):
                with open(os.path.join(build_dir, name)) as log:
                    f.write(f"== {name}\n{log.read()}\n")
gen = torch.Generator(device=dev).manual_seed(0)
sms = torch.cuda.get_device_properties(0).multi_processor_count
records, bad = [], 0
L = N_LAYERS_TIMED


def turns(old, new, iters):
    """Device ms of old and new, timed old, new, new, old; medians."""
    t = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        t[which].append(time_ms(old if which == "old" else new, iters, 3))
    return statistics.median(t["old"]), statistics.median(t["new"])


def run_case(kernel, proj, rows, new, old, plain, steps, byts, flops, plan, **extra):
    global bad
    got = new(0)
    cmp = compare(got, plain(0), steps)
    cmp_old = compare(got, old(0), steps)
    old_ms, new_ms = turns(old, new, 20 if rows <= 8 else 5)
    b_ms, b_by = bound(byts, flops)
    rec = {"kernel": kernel, "proj": proj, "rows": rows, **extra, "ok": cmp["ok"],
           "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"], "parent_ms": old_ms,
           "ms": new_ms, "speedup": old_ms / new_ms, "bound_ms": b_ms, "bound_by": b_by,
           "plan": dataclasses.asdict(plan)}
    records.append(rec)
    bad += not cmp["ok"]
    print(json.dumps(rec), flush=True)


with torch.inference_mode():
    for name, out_f, in_f, grp in ([] if ONLY == "b15" else GATHER16_PROJS):
        ig = in_f // grp
        codes = torch.randint(-32768, 32768, (L, out_f, ig), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int16)
        cb = (torch.randn((L, 65536 * grp // 128, 128), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
        for rows in ROWS_1X16:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            kernel = "gather16_gemv" if rows <= 8 else "gather16_gemm"
            fn = "gemv_launch" if rows <= 8 else "gemm_launch"
            new_fn, old_fn = getattr(g16_new, fn), getattr(g16_old, fn)
            run_case(kernel, name, rows,
                     lambda i=0: new_fn(x[i % L], codes[i % L], cb[i % L], scales[i % L], grp),
                     lambda i=0: old_fn(x[i % L], codes[i % L], cb[i % L], scales[i % L], grp),
                     lambda i=0: g16_new.plain(x[0], codes[0], cb[0], scales[0], grp), 1,
                     out_f * ig * 2 + 65536 * grp * 2 + rows * in_f * 2 + rows * out_f * 2 + out_f * 4,
                     2.0 * rows * out_f * in_f, g16_new.plan(rows, out_f, ig, grp, sms), group=grp)
        del codes, cb, scales
        torch.cuda.empty_cache()

    for name, out_f, in_f in ([] if ONLY == "b1" else ONEHOT_PROJS):
        K, ig = 2, in_f // 8
        codes = torch.randint(0, 256, (L, K, ig, out_f), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((L, K, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
        for rows in ROWS_FALCON:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run_case("onehot_matmul", name, rows,
                     lambda i=0: k15_new.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8),
                     lambda i=0: k15_old.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8),
                     lambda i=0: k15_new.plain(x[0], codes[0], cb[0], scales[0]), 2,
                     K * ig * out_f + rows * in_f * 2 + rows * out_f * 2 + K * 256 * 8 * 2 + out_f * 4,
                     2.0 * rows * out_f * in_f, k15_new.onehot_plan(rows, out_f, ig, K, sms))
        del codes, cb, scales
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
print("bad", bad, flush=True)
sys.exit(1 if bad else 0)
