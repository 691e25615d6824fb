"""Time the parent commit's int4 (W4A16) decode GEMV and K3 (with B6, its
twin without the row write) against this checkout's, in one process on one
card, in turns (parent, new, new, parent).

    git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent   # once, here
    python3 experiments/torch_int4_k3_ab.py build/parent [OUT_JSON] [int4|k3]

PARENT is a directory holding the parent's ``aqlm_tpu_torch`` package; its
kernels build under PARENT/build/kernels. Both packages are imported into
this process (the parent's second, under the same name: each module keeps
the ``_build`` it was imported with, and each ctypes library resolves its own
symbols). Shapes:

- the int4 GEMV at chip_smoke.INT4_PROJS (Llama-2-7B's fused qkv, o, fused
  gate/up and down) and MOE_PROJS (Mixtral-8x7B's all-expert gate/up,
  shared x, and down, per-expert x) at rows 1, 2, 4 and 8, beside
  ``torch._weight_int4pack_mm`` on the same q and scales (dense shapes);
- K3 at chip_smoke.K3_SHAPES (Llama-2-7B, Falcon-7B's split-KV path,
  Mixtral-8x7B), int8 and bf16 caches of 2048 rows, no window and a window
  of 256, B=4 at offsets 0/511/512/1999, and Llama-2-7B at B=1, offset
  1999; B6 at the same shapes at lengths 1/512/513/2048.

Each new result is held against its plain version (chip_smoke.compare, one
bf16 step) and the parent's, and K3's written rows against the plain
version's; times are chip_smoke.time_ms (CUDA-graph replays, median of the
turns) over stacked copies (8 dense layers, 2 all-expert layers, 4 cache
layers), so weights and caches come from device memory. Prints one JSON
line per shape (with the new launch's plan), writes all of them to OUT_JSON
(default chiprun_out/int4_k3_ab.json) and both checkouts' ptxas reports to
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

from chip_smoke import (INT4_PROJS, K3_OFFSETS, K3_SHAPES, MOE_PROJS, N_LAYERS_TIMED,  # noqa: E402
                        _int4_library, bound, compare, time_ms)

parent_root = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "int4_k3_ab.json")
ONLY = sys.argv[3] if len(sys.argv) > 3 else None  # time one kernel's shapes alone

import aqlm_tpu_torch.ops.flash_decode as fd_new  # noqa: E402
import aqlm_tpu_torch.ops.int4_matmul as i4_new  # noqa: E402

for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
    del sys.modules[name]
sys.path.insert(0, parent_root)
import aqlm_tpu_torch.ops.flash_decode as fd_old  # noqa: E402
import aqlm_tpu_torch.ops.int4_matmul as i4_old  # noqa: E402

assert i4_old.__file__.startswith(parent_root) and i4_new.__file__.startswith(ROOT + os.sep)
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
i4_new._build.library()
i4_old._build.library()
os.makedirs("chiprun_out", exist_ok=True)
for tag, build_dir in (("new", i4_new._build.BUILD_DIR), ("parent", i4_old._build.BUILD_DIR)):
    with open(os.path.join("chiprun_out", f"ptxas_{tag}.txt"), "w") as f:
        for name in sorted(os.listdir(build_dir)):
            if name.endswith(".log"):
                with open(os.path.join(build_dir, name)) as log:
                    f.write(f"== {name}\n{log.read()}\n")
gen = torch.Generator(device=dev).manual_seed(0)
sms = torch.cuda.get_device_properties(0).multi_processor_count
records, bad = [], 0
GEMV_ROWS = (1, 2, 4, 8)


def turns(old, new, iters):
    """Device ms of old and new, timed old, new, new, old; medians."""
    t = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        t[which].append(time_ms(old if which == "old" else new, iters, 3))
    return statistics.median(t["old"]), statistics.median(t["new"])


def emit(rec, ok):
    global bad
    records.append(rec)
    bad += not ok
    print(json.dumps(rec), flush=True)


def int4_case(proj, rows, new, old, plain, library, byts, flops, plan, **extra):
    got = new(0)
    cmp = compare(got, plain(0))
    cmp_old = compare(got, old(0))
    ok = cmp["ok"] and torch.equal(got, new(0))  # bit-identical run to run
    iters = 20 if extra.get("experts", 1) == 1 else 10
    old_ms, new_ms = turns(old, new, iters)
    b_ms, b_by = bound(byts, flops)
    rec = {"kernel": "int4_gemv", "proj": proj, "rows": rows, **extra, "ok": ok,
           "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"], "parent_ms": old_ms,
           "ms": new_ms, "speedup": old_ms / new_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if library is None else time_ms(library, iters, 3),
           "plan": dataclasses.asdict(plan)}
    emit(rec, ok)


with torch.inference_mode():
    for name, out_f, in_f in ([] if ONLY == "k3" else INT4_PROJS):
        L = N_LAYERS_TIMED
        packs = [i4_new.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev)
                                      * in_f ** -0.5) for _ in range(L)]
        w4, gs = torch.stack([p[0] for p in packs]), torch.stack([p[1] for p in packs])
        lib = [_int4_library(w4[i], gs[i], in_f) for i in range(L)]
        del packs
        n_groups = gs.shape[1]
        for rows in GEMV_ROWS:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            int4_case(name, rows,
                      lambda i=0: i4_new.launch(x[i % L], w4[i % L], gs[i % L]),
                      lambda i=0: i4_old.launch(x[i % L], w4[i % L], gs[i % L]),
                      lambda i=0: i4_new.plain(x[0], w4[0], gs[0]),
                      lambda i=0: torch._weight_int4pack_mm(x[i % L], lib[i % L][0], 128,
                                                            lib[i % L][1]),
                      out_f * in_f // 2 + 4 * out_f * n_groups + rows * in_f * 2 + rows * out_f * 2,
                      2.0 * rows * out_f * in_f,
                      i4_new.plan(rows, out_f, in_f, w4.shape[-1], 1, sms))
        del w4, gs, lib
        torch.cuda.empty_cache()

    for name, E, out_f, in_f, per_expert in ([] if ONLY == "k3" else MOE_PROJS):
        L = 2  # one launch reads 235 MB, past the 50 MB L2
        packs = [i4_new.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev)
                                      * in_f ** -0.5) for _ in range(L * E)]
        w4 = torch.stack([p[0] for p in packs]).reshape(L, E, out_f, -1)
        gs = torch.stack([p[1] for p in packs]).reshape(L, E, -1, out_f)
        del packs
        n_groups = gs.shape[2]
        for rows in GEMV_ROWS:
            x = torch.randn((L, E, rows, in_f) if per_expert else (L, rows, in_f), generator=gen,
                            device=dev).to(torch.bfloat16)
            int4_case(name, rows,
                      lambda i=0: i4_new.moe_launch(x[i % L], w4[i % L], gs[i % L]),
                      lambda i=0: i4_old.moe_launch(x[i % L], w4[i % L], gs[i % L]),
                      lambda i=0: i4_new.moe_plain(x[0], w4[0], gs[0]), None,
                      E * out_f * in_f // 2 + E * n_groups * out_f * 4 + x[0].numel() * 2
                      + E * rows * out_f * 2, 2.0 * E * rows * out_f * in_f,
                      i4_new.plan(rows, out_f, in_f, w4.shape[-1], E, sms), experts=E,
                      x="per expert" if per_expert else "shared")
        del w4, gs
        torch.cuda.empty_cache()

    Lk, S = 4, 2048
    cases = [(*shape, quant, window, K3_OFFSETS) for shape in K3_SHAPES for quant in (True, False)
             for window in (None, 256)]
    cases += [(*K3_SHAPES[0], quant, None, K3_OFFSETS[-1:]) for quant in (True, False)]
    for model, H, rep, D, quant, window, offs in ([] if ONLY == "int4" else cases):
        B = len(offs)
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        lengths = torch.tensor([o + 1 for o in offs], dtype=torch.int32, device=dev)
        q = torch.randn((B, 1, H * rep, D), generator=gen, device=dev).to(torch.bfloat16)
        if quant:
            kv = [torch.randint(-127, 128, (Lk, B, H, S, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
            sc = [torch.rand((Lk, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
            new = [torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int8) for _ in range(2)]
            nsc = [torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        else:
            kv = [torch.randn((Lk, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            sc, nsc = [None, None], [None, None]
            new = [torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2)]
        ref = [None if t is None else t[0].clone() for t in kv + sc]
        q_hm = q.reshape(B, H, rep, D)
        nk, nv = new[0][:, 0].contiguous(), new[1][:, 0].contiguous()
        nks = None if nsc[0] is None else nsc[0][:, 0, :, 0].contiguous()
        nvs = None if nsc[1] is None else nsc[1][:, 0, :, 0].contiguous()
        row_bytes = 2 * (D + 4) if quant else 2 * 2 * D
        keys = [min(o + 1, window or S) for o in offs]
        shape = {"model": model, "kv": "int8" if quant else "bf16", "window": window, "B": B,
                 "Hkv": H, "rep": rep, "D": D}
        plan = (dataclasses.asdict(fd_new.row_plan(B, H, rep, D, S, quant, window, sm_count=sms))
                if rep in fd_new.ROW_REPS else None)
        for kernel in ("flash_decode_write", "flash_decode"):
            if kernel == "flash_decode_write":
                mk = lambda fd: (lambda i=0: fd.flash_decode_write_attention_indexed(
                    q, new[0], new[1], kv[0], kv[1], sc[0], sc[1], i % Lk, offsets,
                    k_scale_new=nsc[0], v_scale_new=nsc[1], window=window)[0].reshape(B, H, rep, D))
                plain = lambda i=0: fd_new.plain(q_hm, nk, nv, nks, nvs, *ref, offsets, D ** -0.5,
                                                 window)
                nbytes = sum(keys) * H * row_bytes + 2 * B * H * rep * D * 2 + B * H * row_bytes
            else:
                mk = lambda fd: (lambda i=0: fd.flash_decode_attention_indexed(
                    q, kv[0], kv[1], sc[0], sc[1], i % Lk, lengths,
                    window=window).reshape(B, H, rep, D))
                plain = lambda i=0: fd_new.plain_attend(q_hm, *ref, lengths, D ** -0.5, window)
                nbytes = sum(keys) * H * row_bytes + 2 * B * H * rep * D * 2
            new_fn, old_fn = mk(fd_new), mk(fd_old)
            got = new_fn(0)
            cmp = compare(got, plain(0))
            cmp_old = compare(got, old_fn(0))
            ok = cmp["ok"] and torch.equal(got, new_fn(0))
            if kernel == "flash_decode_write":  # the rows the kernels wrote equal the plain's
                ok = ok and all(torch.equal(t[0], r) for t, r in zip(kv + sc, ref) if r is not None)
            old_ms, new_ms = turns(old_fn, new_fn, 50)
            b_ms, b_by = bound(nbytes + B * 4, sum(keys) * H * rep * 4.0 * D)
            rows = ({"offsets": offs} if kernel == "flash_decode_write"
                    else {"lengths": lengths.tolist()})
            rec = {"kernel": kernel, **shape, **rows, "ok": ok, "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                   "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "row_plan": plan}
            emit(rec, ok)
        del kv, sc, ref
        torch.cuda.empty_cache()

with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
print("bad", bad, flush=True)
sys.exit(1 if bad else 0)
