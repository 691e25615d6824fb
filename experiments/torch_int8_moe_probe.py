"""Short first check of the port's all-expert int8 kernel on the card.

    python3 experiments/torch_int8_moe_probe.py   # from the root of a checkout, one CUDA card

Builds the kernels, prints the int8 kernel's ptxas report, compares the
all-expert kernel (``int8_moe_matmul``) with its plain version, and two runs
with each other, at split-K shapes (E=2, OUT=128) and at Mixtral-8x7B's
expert shapes (gate/up with shared x, down with per-expert x), and times the
dense int8 path (fused qkv of Llama-2-7B) and the Mixtral shapes as CUDA-graph
replays (``chip_smoke.time_ms``). Exits non-zero on any mismatch.
"""
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

from aqlm_tpu_torch.ops import _build  # noqa: E402
from aqlm_tpu_torch.ops import int8_matmul as im  # noqa: E402
from chip_smoke import compare, time_ms  # noqa: E402

t0 = time.time()
try:
    lib, build_s = _build.library()
except Exception as e:
    print(str(e)[-6000:])
    sys.exit(1)
print("build", build_s)
with open(os.path.join(_build.BUILD_DIR, "int8_matmul.o.log")) as f:
    print(f.read()[-3000:])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)


def weights(E, out_f, in_f, L=1):
    ld = im.pad_in_features(in_f)
    w8 = torch.randint(-127, 128, (L, E, out_f, ld), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    w8[..., in_f:] = 0
    scale = torch.rand((L, E, out_f), generator=g, device=dev) / (127 * in_f ** 0.5)
    return w8, scale


bad = 0
for E, out_f, in_f, rows_list in [(2, 128, 4096, (1, 3, 8, 9, 64, 200)),
                                  (3, 520, 1040, (1, 5, 8, 77)),
                                  (8, 14336, 4096, (1, 4, 8, 64, 1024)),
                                  (8, 4096, 14336, (1, 4, 8, 64, 1024))]:
    w8, scale = weights(E, out_f, in_f, L=2)
    for rows in rows_list:
        for per_expert in (False, True):
            shape = (E, rows, in_f) if per_expert else (rows, in_f)
            x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            got = im.int8_moe_matmul_indexed(x, w8, scale, 1)
            torch.cuda.synchronize()
            want = im.moe_plain(x, w8[1], scale[1])
            cmp = compare(got, want)
            det = torch.equal(got, im.int8_moe_matmul_indexed(x, w8, scale, 1))
            print(E, out_f, in_f, rows, "per_expert" if per_expert else "shared", cmp["ok"],
                  cmp["max_abs_err"], "det", det, flush=True)
            bad += (not cmp["ok"]) or (not det)
    del w8, scale
    torch.cuda.empty_cache()

# dense path: Llama-2-7B qkv and down, to hold against the int8 rows of PERF.md
for out_f, in_f in [(12288, 4096), (4096, 11008)]:
    ld = im.pad_in_features(in_f)
    w8 = torch.randint(-127, 128, (8, out_f, ld), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    w8[..., in_f:] = 0
    scale = torch.rand((8, out_f), generator=g, device=dev) / (127 * in_f ** 0.5)
    for rows in (4, 1024):
        x = torch.randn((8, rows, in_f), generator=g, device=dev).to(torch.bfloat16)
        ok = compare(im.launch(x[0], w8[0], scale[0]), im.plain(x[0], w8[0], scale[0]))["ok"]
        bad += not ok
        ms = time_ms(lambda i=0: im.launch(x[i % 8], w8[i % 8], scale[i % 8]), 50)
        print("dense", out_f, in_f, rows, ok, "ms", ms, flush=True)
    del w8, scale
    torch.cuda.empty_cache()

for E, out_f, in_f, per_expert in [(8, 14336, 4096, False), (8, 4096, 14336, True)]:
    w8, scale = weights(E, out_f, in_f, L=2)
    for rows in (1, 4, 8, 64, 256, 1024):
        shape = (2, E, rows, in_f) if per_expert else (2, rows, in_f)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ms = time_ms(lambda i=0: im.moe_launch(x[i % 2], w8[i % 2], scale[i % 2]),
                     20 if rows <= 8 else 5)
        nbytes = E * out_f * in_f + x[0].numel() * 2 + E * rows * out_f * 2 + E * out_f * 4
        print("moe", E, out_f, in_f, rows, "ms", ms, "bytes_ms", nbytes / 3.35e9,
              "ops_ms", 2.0 * E * rows * out_f * in_f / 989e9, flush=True)
    del w8, scale
    torch.cuda.empty_cache()
print("BAD", bad, "total", time.time() - t0)
sys.exit(1 if bad else 0)
