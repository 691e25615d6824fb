"""Time the int4 kernel of one copy of aqlm_tpu_torch, for A/B comparisons.

    python3 experiments/torch_int4_ab.py ROOT TAG [check]

ROOT is a directory holding an ``aqlm_tpu_torch`` package (``.`` for the
checkout; copies of the package in other directories build their kernels
under their own ``build/kernels``). With ``check``, the kernel is first
compared with its plain version (and two runs with each other) at rows 1-8
of small and partial-block shapes. Then it prints one JSON line of device
times in ms (CUDA-graph replays of 50 calls, 10 at T=1024, cycling 8 stacked
copies, median of 5) at the four Llama-2-7B projections and rows 1, 2, 4, 8
and 1024. Compare two copies within one process run on one card, in turns
(A, B, B, A).
"""
import sys, os, json, statistics
root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))
import torch
from aqlm_tpu_torch.ops import _build
from aqlm_tpu_torch.ops import int4_matmul as m
assert m.__file__.startswith(os.path.abspath(root)), m.__file__
_build.library()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
L = 8
def time_ms(fn, iters=50):
    side = torch.cuda.Stream(); side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side): fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters): fn(i)
    graph.replay(); torch.cuda.synchronize(); out = []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); graph.replay(); e.record(); torch.cuda.synchronize(); out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)
bad = 0
if len(sys.argv) > 3:
    for out_f, in_f in [(520, 11008), (256, 1152), (384, 384), (4096, 4096)]:
        w4, gs = m.quantize_int4(torch.randn((out_f, in_f), generator=g, device=dev) / in_f ** 0.5)
        for rows in range(1, 9):
            x = torch.randn((rows, in_f), generator=g, device=dev).to(torch.bfloat16)
            got = m.launch(x, w4, gs); want = m.plain(x, w4, gs)
            err = (got.float() - want.float()).abs(); tol = 2**-7 * want.float().abs() + 1e-3 * want.float().abs().max()
            ok = bool((err <= tol).all()) and torch.equal(got, m.launch(x, w4, gs))
            bad += not ok
            if not ok: print("FAIL", out_f, in_f, rows, float(err.max()))
    print(tag, "check bad", bad, flush=True)
res = {}
for name, out_f, in_f in [("qkv", 12288, 4096), ("o", 4096, 4096), ("gate_up", 22016, 4096), ("down", 4096, 11008)]:
    packs = [m.quantize_int4(torch.randn((out_f, in_f), generator=g, device=dev) / in_f ** 0.5) for _ in range(L)]
    w4 = torch.stack([p[0] for p in packs]); gs = torch.stack([p[1] for p in packs]); del packs
    for rows in (1, 2, 4, 8, 1024):
        x = torch.randn((L, rows, in_f), generator=g, device=dev).to(torch.bfloat16)
        res[f"{name}/{rows}"] = round(time_ms(lambda i=0: m.launch(x[i % L], w4[i % L], gs[i % L]), 50 if rows <= 8 else 10), 5)
    del w4, gs; torch.cuda.empty_cache()
print(tag, json.dumps(res), flush=True)
sys.exit(1 if bad else 0)
