"""Short first check of the port's int4 kernel on the card.

    python3 experiments/torch_int4_probe.py   # from the root of a checkout, one CUDA card

Builds the kernels, prints the int4 kernel's ptxas report, compares the
kernel with its plain version (and two runs with each other) at Llama-2-7B
and partial-block shapes, checks the nibble order with one-hot activations,
and times a few shapes eagerly (CUDA events around 50 wrapper calls, the
wrapper's host issue included). Exits non-zero on any mismatch.
"""
import sys, os, time, json
sys.path.insert(0, os.getcwd())
import torch
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops import int4_matmul as m
t0 = time.time()
try:
    lib, bs = _build.library()
except Exception as e:
    print(str(e)[-6000:]); sys.exit(1)
print("build", bs)
os.makedirs("chiprun_out", exist_ok=True)
for name in sorted(os.listdir(_build.BUILD_DIR)):
    if name.startswith("int4") and name.endswith(".log"):
        with open(os.path.join(_build.BUILD_DIR, name)) as f:
            print(f.read()[-3000:])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
def close(a, b):
    a, b = a.float(), b.float()
    err = (a - b).abs(); tol = 2**-7 * b.abs() + 1e-3 * b.abs().max()
    return bool((err <= tol).all()), float(err.max()), float(b.abs().max())
bad = 0
for out_f, in_f in [(520, 11008), (256, 1152), (12288, 4096), (4096, 11008), (384, 384)]:
    dense = torch.randn((out_f, in_f), generator=g, device=dev) / in_f ** 0.5
    w4, gs = m.quantize_int4(dense)
    for rows in (1, 2, 3, 4, 5, 8, 9, 64, 77, 200, 1024):
        if out_f * in_f > 20e6 and rows not in (1, 4, 8, 64, 1024): continue
        x = torch.randn((rows, in_f), generator=g, device=dev).to(torch.bfloat16)
        got = m.launch(x, w4, gs); torch.cuda.synchronize()
        want = m.plain(x, w4, gs)
        ok, e, s = close(got, want)
        det = torch.equal(got, m.launch(x, w4, gs))
        print(out_f, in_f, rows, ok, e, s, "det", det, flush=True)
        bad += (not ok) or (not det)
# one-hot nibble order
w4, gs = m.quantize_int4(torch.randn((128, 512), generator=g, device=dev))
for col in (0, 5, 127, 128, 200, 255, 256, 300, 511):
    for rows in (1, 16):
        x = torch.zeros((rows, 512), device=dev, dtype=torch.bfloat16); x[:, col] = 1
        got = m.launch(x, w4, gs).float()
        want = m.dequantize_int4(w4, gs)[:, col].to(torch.bfloat16).float()
        ok = torch.equal(got[0], want)
        bad += not ok
        if not ok: print("onehot fail", col, rows)
# timing quick
for out_f, in_f in [(12288, 4096), (4096, 11008)]:
    dense = torch.randn((out_f, in_f), generator=g, device=dev) / in_f ** 0.5
    w4, gs = m.quantize_int4(dense)
    for rows in (1, 4, 8, 1024):
        x = torch.randn((rows, in_f), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3): m.launch(x, w4, gs)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(50): m.launch(x, w4, gs)
        e.record(); torch.cuda.synchronize()
        print("time", out_f, in_f, rows, s.elapsed_time(e) / 50, flush=True)
print("BAD", bad, "total", time.time() - t0)
sys.exit(1 if bad else 0)
