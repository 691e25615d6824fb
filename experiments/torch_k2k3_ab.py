"""Time the parent commit's K2 and K3/B6 split kernels against this checkout's,
in one process on one card, in turns (parent, new, new, parent).

    git archive HEAD~ aqlm_tpu_torch | tar -x -C build/parent   # once, here
    python3 experiments/torch_k2k3_ab.py build/parent [OUT_JSON]

PARENT is a directory holding the parent's ``aqlm_tpu_torch`` package; its
kernels build under PARENT/build/kernels. Both packages are imported into
this process (the parent's second, under the same name: each module keeps
the ``_build`` it was imported with, and each ctypes library resolves its own
symbols). Shapes:

- K2 (bf16) at chip_smoke.check_k1_k2's projections (Llama-2-7B's fused qkv,
  o, fused gate/up, down, Falcon-7B's fc1) at the codes run's prefill rows;
- K2's all-expert f32 route at chip_smoke.check_moe_codes' Mixtral-8x7B
  gate/up (shared x) and down (per-expert x) at the prefill rows: the parent
  launches it once per expert, this checkout once;
- K3 at Falcon-7B's shape (B=4, 71 query heads over one kv head, D=64,
  offsets 0/511/512/1999), int8 and bf16 cache, window none and 256, and B6
  at lengths 1/512/513/2048, with SDPA over the bf16 cache (or the int8
  cache's bf16 twin) as the yardstick.

Each new result is held against its plain version (chip_smoke.compare) and
the parent's; times are chip_smoke.time_ms (CUDA-graph replays, median).
Prints one JSON line per shape and writes all of them to OUT_JSON
(default chiprun_out/k2k3_ab.json). Exits non-zero on a mismatch.
"""
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import (MOE_PROJS, PROJS, _proj_inputs, bound, compare,  # noqa: E402
                        engine_serve_config, main_path_rows, time_ms)

parent_root = os.path.abspath(sys.argv[1])
out_json = sys.argv[2] if len(sys.argv) > 2 else os.path.join("chiprun_out", "k2k3_ab.json")

import aqlm_tpu_torch.ops.flash_decode as fd_new  # noqa: E402
import aqlm_tpu_torch.ops.gather_prefill as gp_new  # noqa: E402
import aqlm_tpu_torch.ops.lut_gemv as lg_new  # noqa: E402

_, PREFILL = main_path_rows(engine_serve_config("codes"))
_, MOE_PREFILL = main_path_rows(engine_serve_config("mixtral_codes"))
for name in [m for m in sys.modules if m == "aqlm_tpu_torch" or m.startswith("aqlm_tpu_torch.")]:
    del sys.modules[name]
sys.path.insert(0, parent_root)
import aqlm_tpu_torch.ops.flash_decode as fd_old  # noqa: E402
import aqlm_tpu_torch.ops.gather_prefill as gp_old  # noqa: E402
import aqlm_tpu_torch.ops.lut_gemv as lg_old  # noqa: E402

assert gp_old.__file__.startswith(parent_root) and gp_new.__file__.startswith(ROOT + os.sep)
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
gp_new._build.library()
gp_old._build.library()
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


with torch.inference_mode():
    L = 8
    for name, sizes, in_f in PROJS:
        codes, cb, scales, pm, (nt, kig, tn, P) = _proj_inputs(gen, sizes, in_f, dev)
        out_f = sum(sizes)
        for rows in PREFILL:
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            new = lambda i=0: gp_new.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], pm, 8)
            old = lambda i=0: gp_old.launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], pm, 8)
            got = new(0)
            cmp = compare(got, gp_new.plain(x[0], codes[0], cb[0], scales[0], pm))
            cmp_old = compare(got, old(0))
            old_ms, new_ms = turns(old, new, 10)
            p = gp_new.plan(rows, out_f, in_f, 2, 256)
            emit({"kernel": "gather_prefill", "proj": name, "rows": rows, "ok": cmp["ok"],
                  "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                  "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                  "bound_ms": bound(0, 2.0 * rows * out_f * in_f)[0],
                  "plan": {"bm": p.bm, "stages": p.stages, "splits": p.splits, "grid": p.grid}})
        del codes, cb, scales
        torch.cuda.empty_cache()

    L = 2
    for name, E, out_f, in_f, per_expert in MOE_PROJS:
        tn = lg_new.lut_tile_n(out_f)
        nt, kig = out_f // tn, in_f // 8 * 2
        codes = torch.randint(0, 256, (L, E, nt, kig, tn), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((L, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((L, E, out_f), generator=gen, device=dev) + 0.5
        for rows in [r for r in MOE_PREFILL if r > 8]:
            shape = (L, E, rows, in_f) if per_expert else (L, rows, in_f)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            new = lambda i=0: gp_new.moe_launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8)
            old = lambda i=0: lg_old.moe_prefill_launch(x[i % L], codes[i % L], cb[i % L],
                                                        scales[i % L], 8)
            got = new(0)
            xs = [x[0][e] if per_expert else x[0] for e in range(E)]
            want = torch.stack([gp_new.plain(xs[e], codes[0, e], cb[0, e][None], scales[0, e],
                                             None, torch.float32) for e in range(E)])
            cmp = compare(got, want)
            cmp_old = compare(got, old(0))
            del want
            old_ms, new_ms = turns(old, new, 3)
            emit({"kernel": "moe_gather_prefill", "proj": name, "experts": E, "rows": rows,
                  "x": "per expert" if per_expert else "shared", "ok": cmp["ok"],
                  "max_abs_err": cmp["max_abs_err"], "vs_parent_ok": cmp_old["ok"],
                  "parent_ms": old_ms, "ms": new_ms, "speedup": old_ms / new_ms,
                  "bound_ms": bound(0, 2.0 * E * rows * out_f * in_f)[0]})
        del codes, cb, scales
        torch.cuda.empty_cache()

    # K3 and B6 at Falcon-7B's decode shape
    L, B, H, rep, D, S = 4, 4, 1, 71, 64, 2048
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    lengths = torch.tensor([1, 512, 513, 2048], dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    for quant in (True, False):
        q = torch.randn((B, 1, H * rep, D), generator=gen, device=dev).to(torch.bfloat16)
        if quant:
            kv = [torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
            sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
            new_rows = [torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int8) for _ in range(2)]
            nsc = [torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50 for _ in range(2)]
            twin = [(kv[j].float() * sc[j]).to(torch.bfloat16) for j in range(2)]
        else:
            kv = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            sc, nsc = [None, None], [None, None]
            new_rows = [torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
                        for _ in range(2)]
            twin = kv
        q_hm = q.reshape(B, H, rep, D)
        for window in (None, 256):
            for kind, rows, mod in (("flash_decode_write", offsets, None),
                                    ("flash_decode", lengths, None)):
                if kind == "flash_decode_write":
                    call = lambda m, i=0: m.flash_decode_write_attention_indexed(
                        q, new_rows[0], new_rows[1], kv[0], kv[1], sc[0], sc[1], i % L, offsets,
                        k_scale_new=nsc[0], v_scale_new=nsc[1], window=window)[0]
                    lens = offsets + 1
                    ref = [None if t is None else t[0].clone() for t in kv + sc]
                    nk, nv = new_rows[0][:, 0].contiguous(), new_rows[1][:, 0].contiguous()
                    nks = None if nsc[0] is None else nsc[0][:, 0, :, 0].contiguous()
                    nvs = None if nsc[1] is None else nsc[1][:, 0, :, 0].contiguous()
                    want = fd_new.plain(q_hm, nk, nv, nks, nvs, *ref, offsets, D ** -0.5, window)
                else:
                    call = lambda m, i=0: m.flash_decode_attention_indexed(
                        q, kv[0], kv[1], sc[0], sc[1], i % L, lengths, window=window)
                    lens = lengths
                    want = fd_new.plain_attend(q_hm, *[None if t is None else t[0] for t in kv + sc],
                                               lengths, D ** -0.5, window)
                got = call(fd_new).reshape(B, H, rep, D)
                cmp = compare(got, want)
                cmp_old = compare(got, call(fd_old).reshape(B, H, rep, D))
                old_ms, new_ms = turns(lambda i=0: call(fd_old, i), lambda i=0: call(fd_new, i), 50)
                lo = (lens[:, None] - window) if window else torch.zeros_like(lens[:, None])
                mask = ((pos[None] < lens[:, None]) & (pos[None] >= lo))[:, None, None, :]
                sdpa_ms = time_ms(lambda i=0: torch.nn.functional.scaled_dot_product_attention(
                    q_hm, twin[0][i % L], twin[1][i % L], attn_mask=mask), 50)
                kps, splits = fd_new.split_plan(B, H, rep, S)
                emit({"kernel": kind, "kv": "int8" if quant else "bf16", "window": window,
                      "ok": cmp["ok"], "max_abs_err": cmp["max_abs_err"],
                      "vs_parent_ok": cmp_old["ok"], "parent_ms": old_ms, "ms": new_ms,
                      "sdpa_bf16_ms": sdpa_ms, "speedup": old_ms / new_ms,
                      "keys_per_split": kps, "splits": splits})
        del kv, sc, twin
        torch.cuda.empty_cache()

os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
print("bad", bad, flush=True)
sys.exit(1 if bad else 0)
