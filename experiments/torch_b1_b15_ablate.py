"""What bounds the redesigned B1 and B15 forms on the card: time copies of
them with one part of their work switched off, in one process on one card.

    python3 experiments/torch_b1_b15_ablate.py [OUT_JSON]

Each variant is an ``aqlm_tpu_torch`` copied under
``build/b1_b15_ablate/<variant>/`` with ``csrc/gather16.cu`` and
``csrc/onehot_matmul.cu`` patched (the checkout's sources are not touched),
built into that copy's build directory and imported in turn (the modules of
each stay bound to their own library):

- ``full``: the kernels as they are;
- ``no_gather``: B1's g=16 GEMV gathers one codebook row for every code (the
  lanes of a warp meet in one L2 sector), B15's GEMV uses a code word as its
  weights instead of dequantizing, and B15's GEMM dequantisers skip their
  work (still keeping every barrier);
- ``no_products``: B1's g=16 GEMV adds one weight a code instead of its FMAs
  (the gathers stay live), B15's GEMV folds the weights into its sums by one
  add instead of mma.sync, and B15's GEMM consumers issue no wgmma.

B1's GEMM is two kernels, so its parts are timed apart in ``full`` with no
patch: the gather pre-pass alone (``prepass``) and the GEMM over an
already-gathered W (``gemm_only``). The variants' outputs are meaningless;
only their times are read. Times are chip_smoke.time_ms (CUDA-graph
replays) over 8 stacked copies at Llama-2-7B 1x16's q (g 8 and 16) and gate
and Falcon-7B's q, k and fc2, decode (B=4) and prefill (T=64, 1024) rows.
Prints one JSON line per variant and shape and writes all to OUT_JSON
(default chiprun_out/b1_b15_ablate.json).
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

B1 = "aqlm_tpu_torch/ops/csrc/gather16.cu"
B15 = "aqlm_tpu_torch/ops/csrc/onehot_matmul.cu"
PATCHES = {
    "full": [],
    "no_gather": [
        (B1, "    return __ldcg(cb + (size_t)code * LPC + half);", "    return __ldcg(cb + half + 0 * code);"),
        (B15, "    const uint4 wa = dequant_group<M>(s_cb, cw, K, S);", "    const uint4 wa = cw[0];"),
        (B15, "    const uint4 wb = dequant_group<M + 8>(s_cb, cw, K, S);", "    const uint4 wb = cw[0];"),
        (B15, "      if (K <= 2) {\n        constexpr int UNR2 = 6;", "      if (false) {\n        constexpr int UNR2 = 6;"),
        (B15, "      } else {\n        constexpr int UNR = 4;", "      } else if (false) {\n        constexpr int UNR = 4;"),
    ],
    "no_products": [
        (B1, "            for (int e = 0; e < 8; ++e) acc[r][b] = fmaf(xv[e], w[r][e], acc[r][b]);",
         "            acc[r][b] += w[r][b & 7] + 0.f * xv[0];"),
        (B15, "    mma_16816(acc[M], wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);",
         "    acc[M][0] += __uint_as_float((wa.x ^ wb.y ^ xv.x) & 0x3fffffffu);"),
        (B15, "    mma_16816(acc[M], wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);",
         "    acc[M][1] += __uint_as_float((wa.z ^ wb.w ^ xv.z) & 0x3fffffffu);"),
        (B15, "      if (active) {\n        fence_proxy_async();", "      if (false) {\n        fence_proxy_async();"),
    ],
}
# (kernel, proj, OUT, IN, group or K, rows)
SHAPES = [("gather16", "q", 4096, 4096, 8, 1024), ("gather16", "gate", 11008, 4096, 8, 1024),
          ("gather16", "q_g16", 4096, 4096, 16, 4), ("gather16", "q_g16", 4096, 4096, 16, 1024),
          ("gather16", "q", 4096, 4096, 8, 64),
          ("onehot", "q", 4544, 4544, 2, 4), ("onehot", "k", 64, 4544, 2, 4),
          ("onehot", "fc2", 4544, 18176, 2, 4), ("onehot", "q", 4544, 4544, 2, 64),
          ("onehot", "q", 4544, 4544, 2, 1024), ("onehot", "fc2", 4544, 18176, 2, 1024)]
out_json = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out", "b1_b15_ablate.json")

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(smi, flush=True)
dev = torch.device("cuda")
records = []
base = os.path.join(ROOT, "build", "b1_b15_ablate")
L = 8  # stacked copies cycled, so the codes come from device memory


def emit(**rec):
    records.append(rec)
    print(json.dumps(rec), flush=True)


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
    from aqlm_tpu_torch.ops import gather16 as g16  # noqa: E402
    from aqlm_tpu_torch.ops import kernels as k15  # noqa: E402
    assert g16.__file__.startswith(root), g16.__file__
    g16._build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for kernel, proj, out_f, in_f, gk, rows in SHAPES:
            if kernel == "gather16" and rows > 8 and variant != "full":
                continue  # the GEMM's parts are timed apart below
            if kernel == "gather16" and rows <= 8 and gk == 8:
                continue  # the g=8 GEMV is the unchanged first design
            x = torch.randn((L, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            iters = 20 if rows <= 64 else 5
            if kernel == "gather16":
                ig = in_f // gk
                codes = torch.randint(-32768, 32768, (L, out_f, ig), generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.int16)
                cb = (torch.randn((L, 65536 * gk // 128, 128), generator=gen, device=dev) / 4).to(torch.bfloat16)
                sc = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
                fn = g16.gemv_launch if rows <= 8 else g16.gemm_launch
                ms = time_ms(lambda i=0: fn(x[i % L], codes[i % L], cb[i % L], sc[i % L], gk), iters, 5)
                emit(variant=variant, kernel=kernel, proj=proj, rows=rows, group=gk, ms=ms)
                if rows > 8:
                    p = g16.plan(rows, out_f, ig, gk)
                    ws = [g16.gather_w(codes[i], cb[i], gk) for i in range(2)]
                    ms_pre = time_ms(lambda i=0: g16.gather_w(codes[i % L], cb[i % L], gk,
                                                              p.prepass_blocks), iters, 5)
                    ms_gemm = time_ms(lambda i=0: g16.gemm_w_launch(x[i % L], ws[i % 2], sc[i % L], p),
                                      iters, 5)
                    emit(variant="prepass", kernel=kernel, proj=proj, rows=rows, group=gk, ms=ms_pre)
                    emit(variant="gemm_only", kernel=kernel, proj=proj, rows=rows, group=gk, ms=ms_gemm)
                    del ws
                del codes, cb, sc
            else:
                ig = in_f // 8
                codes = torch.randint(0, 256, (L, gk, ig, out_f), generator=gen, device=dev,
                                      dtype=torch.int32).to(torch.uint8)
                cb = (torch.randn((L, gk, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
                sc = torch.rand((L, out_f), generator=gen, device=dev) + 0.5
                ms = time_ms(lambda i=0: k15.launch(x[i % L], codes[i % L], cb[i % L], sc[i % L], 8),
                             iters, 5)
                emit(variant=variant, kernel=kernel, proj=proj, rows=rows, K=gk, ms=ms)
                del codes, cb, sc
            del x
            torch.cuda.empty_cache()
    sys.path.remove(root)

os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
with open(out_json, "w") as f:
    json.dump({"nvidia_smi": smi, "records": records}, f, indent=1)
