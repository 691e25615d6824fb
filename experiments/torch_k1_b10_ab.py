"""Time the parent commit's K1 (the Kx8 LUT-GEMV, dense and all-expert) and
B10 (the int8 activation backward) against this checkout's, in one process
on one card, in turns (parent, new, new, parent).

    git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent   # once, here
    python3 experiments/torch_k1_b10_ab.py build/parent [OUT_JSON] [k1|b10]

PARENT is a directory holding the parent's ``aqlm_tpu_torch`` package; its
kernels build under PARENT/build/kernels. Both packages are imported into
this process (the parent's second, under the same name: each module keeps
the ``_build`` it was imported with, and each ctypes library resolves its own
symbols). Shapes:

- K1 at chip_smoke.check_k1_k2's projections (Llama-2-7B's fused qkv, o,
  fused gate/up, down, Falcon-7B's fc1) at the codes run's decode rows, and
  the fused qkv at 1 and 8 codebooks (B=4);
- K1's all-expert instance at chip_smoke.check_moe_codes' Mixtral-8x7B
  gate/up (shared x) and down (per-expert x) at the decode rows;
- B10 at the lora phase's q (T=1, 8, 200, 1024), gate and down (T=1024),
  bf16 g, with one ``torch._weight_int8pack_mm`` over w8^T as the yardstick
  at T=1 and 8.

Each new result is held against its plain version (chip_smoke.compare) and
the parent's; times are chip_smoke.time_ms (CUDA-graph replays, median of
the turns). Prints one JSON line per shape, writes all of them to OUT_JSON
(default chiprun_out/k1_b10_ab.json) and both checkouts' ptxas reports to
chiprun_out/ptxas_new.txt and chiprun_out/ptxas_parent.txt (compare them with
experiments/ptxas_compare.py). Exits non-zero on a mismatch.
"""
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import (BWD_PROJS, MOE_PROJS, PROJS, _proj_inputs, bound,  # noqa: E402
                        compare, engine_serve_config, main_path_rows, time_ms)

parent_root = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "k1_b10_ab.json")
ONLY = sys.argv[3] if len(sys.argv) > 3 else None  # time one kernel's shapes alone

import aqlm_tpu_torch.ops.int8_matmul as im_new  # noqa: E402
import aqlm_tpu_torch.ops.lut_gemv as lg_new  # noqa: E402

DECODE, _ = main_path_rows(engine_serve_config("codes"))
MOE_DECODE, _ = main_path_rows(engine_serve_config("mixtral_codes"))
for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
    del sys.modules[name]
sys.path.insert(0, parent_root)
import aqlm_tpu_torch.ops.int8_matmul as im_old  # noqa: E402
import aqlm_tpu_torch.ops.lut_gemv as lg_old  # noqa: E402

assert lg_old.__file__.startswith(parent_root) and lg_new.__file__.startswith(ROOT + os.sep)
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
lg_new._build.library()
lg_old._build.library()
os.makedirs("chiprun_out", exist_ok=True)
for tag, build_dir in (("new", lg_new._build.BUILD_DIR), ("parent", lg_old._build.BUILD_DIR)):
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


def emit(rec):
    global bad
    records.append(rec)
    bad += not rec["ok"]
    print(json.dumps(rec), flush=True)


def plan_of(p):
    return {k: getattr(p, k) for k in ("cols", "colvec", "stages", "splits", "gb_per_split",
                                       "grid", "smem")}


with torch.inference_mode():
    L = 8  # stacked copies cycled, so the codes come from HBM
    cases = [(name, sizes, in_f, 2, DECODE) for name, sizes, in_f in PROJS]
    cases += [("qkv", (4096, 4096, 4096), 4096, K, [4]) for K in (1, 8)]
    if ONLY == "b10":
        cases = []
    for name, sizes, in_f, K, rows_list in cases:
        if K == 2:
            codes, cb, scales, pm, (nt, kig, tn, P) = _proj_inputs(gen, sizes, in_f, dev)
        else:
            tn = min(lg_new.lut_tile_n(s) for s in sizes)
            nt, kig, P = sum(sizes) // tn, in_f // 8 * K, len(sizes)
            codes = torch.randint(0, 256, (L, nt, kig, tn), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.uint8)
            cb = (torch.randn((L, P, K, 256, 8), generator=gen, device=dev) / (2 * K)).to(
                torch.bfloat16)
            scales = torch.rand((L, sum(sizes)), generator=gen, device=dev) + 0.5
            pm = lg_new.proj_map_for(sizes, tn, dev)
        out_f, gcd = sum(sizes), math.gcd(*sizes)
        for rows in rows_list:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            new = lambda i=0: lg_new.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], pm,
                                            torch.bfloat16, 8, proj_cols=gcd)
            old = lambda i=0: lg_old.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], pm,
                                            torch.bfloat16, 8)
            got = new(0)
            cmp = compare(got, lg_new.plain(x[0], codes[0], cb[0], scales[0], pm, torch.bfloat16))
            cmp_old = compare(got, old(0))
            old_ms, new_ms = turns(old, new, 50)
            p = lg_new.plan(rows, K, out_f, in_f // 8, tn, P, 1, 132, gcd)
            byts = nt * kig * tn + rows * in_f * 2 + rows * out_f * 2 + P * K * 256 * 16 + out_f * 4
            emit({"kernel": "lut_gemv", "proj": name, "K": K, "rows": rows, "ok": cmp["ok"],
                  "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                  "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                  "bound_ms": bound(byts, 2.0 * rows * out_f * in_f)[0], "plan": plan_of(p)})
        del codes, cb, scales
        torch.cuda.empty_cache()

    L = 2
    for name, E, out_f, in_f, per_expert in ([] if ONLY == "b10" else MOE_PROJS):
        tn = lg_new.lut_tile_n(out_f)
        nt, kig = out_f // tn, in_f // 8 * 2
        codes = torch.randint(0, 256, (L, E, nt, kig, tn), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((L, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((L, E, out_f), generator=gen, device=dev) + 0.5
        for rows in MOE_DECODE:
            shape = (L, E, rows, in_f) if per_expert else (L, rows, in_f)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            new = lambda i=0: lg_new.moe_launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8)
            old = lambda i=0: lg_old.moe_launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8)
            got = new(0)
            cmp = compare(got, lg_new.moe_plain(x[0], codes[0], cb[0], scales[0]))
            cmp_old = compare(got, old(0))
            old_ms, new_ms = turns(old, new, 20)
            p = lg_new.plan(rows, 2, out_f, in_f // 8, tn, 1, E)
            byts = E * nt * kig * tn + x[0].numel() * 2 + E * rows * out_f * 4 + E * 8192 + E * out_f * 4
            emit({"kernel": "lut_moe_gemv", "proj": name, "experts": E, "rows": rows,
                  "x": "per expert" if per_expert else "shared", "ok": cmp["ok"],
                  "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                  "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                  "bound_ms": bound(byts, 2.0 * E * rows * out_f * in_f)[0], "plan": plan_of(p)})
        del codes, cb, scales
        torch.cuda.empty_cache()

    L = 8
    for name, out_f, in_f in ([] if ONLY == "k1" else BWD_PROJS):
        ld = im_new.pad_in_features(in_f)
        w8 = torch.randint(-127, 128, (L, out_f, ld), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        scale = torch.rand((L, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        w_lib = w8[0].t().contiguous()  # the yardstick's operand only
        ones = torch.ones(ld, dtype=torch.bfloat16, device=dev)
        for rows in ([1, 8, 200, 1024] if name == "q" else [1024]):
            g = torch.randn((L, rows, out_f), generator=gen, device=dev).to(torch.bfloat16)
            new = lambda i=0: im_new.launch_t(g[i % L], w8[i % L], scale[i % L])
            old = lambda i=0: im_old.launch_t(g[i % L], w8[i % L], scale[i % L])
            got = new(0)
            cmp = compare(got, im_new.plain_t(g[0], w8[0], scale[0]))
            cmp_old = compare(got, old(0))
            old_ms, new_ms = turns(old, new, 20)
            library_ms = None
            if rows <= 8:
                gs = im_new.scaled_grad(g[0], scale[0])
                library_ms = time_ms(lambda i=0: torch._weight_int8pack_mm(gs, w_lib, ones), 20)
            p = im_new.plan_t(rows, out_f, ld)
            b_ms, b_by = bound(out_f * ld + rows * out_f * 2 + out_f * 4 + rows * ld * 2,
                               2.0 * rows * out_f * ld)
            emit({"kernel": "int8_matmul_transposed", "proj": name, "rows": rows, "ok": cmp["ok"],
                  "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                  "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                  "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "plan": {"path": p.path, "tile": p.tile, "stages": p.stages,
                           "splits": p.splits, "per_split": p.per_split, "grid": p.grid}})
        del w8, scale, w_lib
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
print("bad", bad, flush=True)
sys.exit(1 if bad else 0)
