"""Time the int8, int4, all-expert int4 or flash-decode (K3) kernel of one
copy of aqlm_tpu_torch, for A/B comparisons.

    python3 experiments/torch_ab.py ROOT TAG {int8,int4,int4_moe,k3} [check]

ROOT is a directory holding an ``aqlm_tpu_torch`` package (``.`` for the
checkout; copies of the package in other directories build their kernels
under their own ``build/kernels``). The timer and the tolerance are this
checkout's (``chip_smoke.time_ms`` and ``chip_smoke.compare``), whatever
ROOT is. With ``check``, the kernel is first compared with its plain version
(and two runs with each other) at rows 1-8 of small and partial-block
shapes. Then it prints one JSON line of device times in ms (CUDA-graph
replays of 50 calls, 10 above 8 rows, cycling 8 stacked copies, median of
5) of the kernel's ``launch`` at Llama-2-7B's four fused projections (and
the lm_head for int8) at rows 1, 2, 4, 8, 64, 256 and 1024, each shape
checked once against the plain version. ``int4_moe`` runs the all-expert
int4 kernel (``moe_launch``, a package that has it) instead: ``check`` at
rows 1-9 and 64 of split-K (E=2, OUT=128) and ragged, padded (E=3, 520 x
1040) shapes with shared and per-expert x, then times at Mixtral-8x7B's
gate/up (shared x) and down (per-expert x), cycling 2 stacked layers. ``k3``
times the fused KV write + flash decode at B=4, 32 query heads over 32, 16,
8 and 4 kv heads (1, 2, 4 and 8 per kv head), D=128 and 64, int8 and bf16
caches of 2048 rows at offsets 0/511/512/1999, cycling 4 layers, each shape
checked once against the plain version (output and written cache). Compare
two copies within one call on one card, in turns (A, B, B, A). Exits
non-zero on any mismatch.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import compare, time_ms  # noqa: E402  (imports no aqlm_tpu_torch)

root, tag, kernel = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.abspath(root))
import torch  # noqa: E402

from aqlm_tpu_torch.ops import _build  # noqa: E402
from aqlm_tpu_torch.ops import flash_decode as fd  # noqa: E402
from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from aqlm_tpu_torch.ops import int8_matmul as i8  # noqa: E402

m = i8 if kernel == "int8" else i4
moe = kernel == "int4_moe"
assert m.__file__.startswith(os.path.abspath(root)), m.__file__
_build.library()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
L = 8

if kernel == "k3":
    Lk, B, S, HQ = 4, 4, 2048, 32
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    bad, res = 0, {}
    for d in (128, 64):
        for rep in (1, 2, 4, 8):
            for quant in (True, False):
                h = HQ // rep
                q = torch.randn((B, 1, HQ, d), generator=g, device=dev).to(torch.bfloat16)
                if quant:
                    kv = [torch.randint(-127, 128, (Lk, B, h, S, d), generator=g, device=dev,
                                        dtype=torch.int32).to(torch.int8) for _ in range(2)]
                    sc = [torch.rand((Lk, B, h, S, 1), generator=g, device=dev) / 50 for _ in range(2)]
                    new = [torch.randint(-127, 128, (B, 1, h, d), generator=g, device=dev,
                                         dtype=torch.int32).to(torch.int8) for _ in range(2)]
                    nsc = [torch.rand((B, 1, h, 1), generator=g, device=dev) / 50 for _ in range(2)]
                else:
                    kv = [torch.randn((Lk, B, h, S, d), generator=g, device=dev).to(torch.bfloat16)
                          for _ in range(2)]
                    sc = nsc = [None, None]
                    new = [torch.randn((B, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
                           for _ in range(2)]
                ref = [[None if t is None else t[0].clone() for t in pair] for pair in (kv, sc)]
                run = lambda i=0: fd.flash_decode_write_attention_indexed(
                    q, new[0], new[1], kv[0], kv[1], sc[0], sc[1], i % Lk, offsets,
                    k_scale_new=nsc[0], v_scale_new=nsc[1])[0]
                want = fd.plain(q.reshape(B, h, rep, d), new[0][:, 0].contiguous(),
                                new[1][:, 0].contiguous(),
                                None if nsc[0] is None else nsc[0][:, 0, :, 0].contiguous(),
                                None if nsc[1] is None else nsc[1][:, 0, :, 0].contiguous(),
                                ref[0][0], ref[0][1], ref[1][0], ref[1][1], offsets, d ** -0.5,
                                None)
                ok = compare(run(0).reshape(B, h, rep, d), want)["ok"]
                ok = ok and torch.equal(kv[0][0], ref[0][0]) and torch.equal(kv[1][0], ref[0][1])
                bad += not ok
                res[f"D{d}/rep{rep}/{'int8' if quant else 'bf16'}"] = round(time_ms(run, 50, 5), 5)
                del kv, sc, ref
                torch.cuda.empty_cache()
    print(tag, kernel, "bad", bad, json.dumps(res), flush=True)
    sys.exit(1 if bad else 0)


def weights(out_f, in_f, n, experts=None):
    """``n`` stacked copies of one projection's weights in the kernel's layout
    (with ``experts``, [n, E, ...])."""
    if kernel == "int8":
        w8 = torch.randint(-127, 128, (n, out_f, i8.pad_in_features(in_f)), generator=g,
                           device=dev, dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        return w8, torch.rand((n, out_f), generator=g, device=dev) / (127 * in_f ** 0.5)
    e = experts or 1
    packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=g, device=dev) / in_f ** 0.5)
             for _ in range(n * e)]
    w4, gs = torch.stack([p[0] for p in packs]), torch.stack([p[1] for p in packs])
    if experts:
        return w4.reshape(n, e, *w4.shape[1:]), gs.reshape(n, e, *gs.shape[1:])
    return w4, gs


if moe:
    bad = 0
    if len(sys.argv) > 4:
        for E, out_f, in_f in [(2, 128, 4096), (3, 520, 1040)]:
            w, s = weights(out_f, in_f, 1, E)
            for rows in (*range(1, 10), 64):
                for shape in ((rows, in_f), (E, rows, in_f)):
                    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                    got = m.moe_launch(x, w[0], s[0])
                    ok = (compare(got, m.moe_plain(x, w[0], s[0]))["ok"]
                          and torch.equal(got, m.moe_launch(x, w[0], s[0])))
                    bad += not ok
                    if not ok:
                        print("FAIL", E, out_f, in_f, shape, flush=True)
        print(tag, "check bad", bad, flush=True)
    res = {}
    for name, E, out_f, in_f, per_expert in [("gate_up", 8, 14336, 4096, False),
                                             ("down", 8, 4096, 14336, True)]:
        w, s = weights(out_f, in_f, 2, E)
        for rows in (1, 2, 4, 8, 64, 256, 1024):
            x = torch.randn((2, E, rows, in_f) if per_expert else (2, rows, in_f), generator=g,
                            device=dev).to(torch.bfloat16)
            bad += not compare(m.moe_launch(x[0], w[0], s[0]), m.moe_plain(x[0], w[0], s[0]))["ok"]
            res[f"{name}/{rows}"] = round(time_ms(lambda i=0: m.moe_launch(x[i % 2], w[i % 2], s[i % 2]),
                                                  20 if rows <= 8 else 5, 5), 5)
        del w, s
        torch.cuda.empty_cache()
    print(tag, kernel, "bad", bad, json.dumps(res), flush=True)
    sys.exit(1 if bad else 0)


bad = 0
if len(sys.argv) > 4:
    for out_f, in_f in [(520, 11008), (256, 1152), (384, 384), (4096, 4096)]:
        w, s = weights(out_f, in_f, 1)
        for rows in range(1, 9):
            x = torch.randn((rows, in_f), generator=g, device=dev).to(torch.bfloat16)
            got = m.launch(x, w[0], s[0])
            ok = compare(got, m.plain(x, w[0], s[0]))["ok"] and torch.equal(got, m.launch(x, w[0], s[0]))
            bad += not ok
            if not ok:
                print("FAIL", out_f, in_f, rows, flush=True)
    print(tag, "check bad", bad, flush=True)

projs = [("qkv", 12288, 4096), ("o", 4096, 4096), ("gate_up", 22016, 4096), ("down", 4096, 11008)]
if kernel == "int8":
    projs.append(("lm_head", 32000, 4096))
res = {}
for name, out_f, in_f in projs:
    w, s = weights(out_f, in_f, L)
    for rows in (1, 2, 4, 8, 64, 256, 1024):
        x = torch.randn((L, rows, in_f), generator=g, device=dev).to(torch.bfloat16)
        bad += not compare(m.launch(x[0], w[0], s[0]), m.plain(x[0], w[0], s[0]))["ok"]
        res[f"{name}/{rows}"] = round(time_ms(lambda i=0: m.launch(x[i % L], w[i % L], s[i % L]),
                                              50 if rows <= 8 else 10, 5), 5)
    del w, s
    torch.cuda.empty_cache()
print(tag, kernel, "bad", bad, json.dumps(res), flush=True)
sys.exit(1 if bad else 0)
