"""Time the int8, int4, all-expert int8 or int4, flash-decode (K3), B13, B14,
B5 or B8 kernel of one copy of aqlm_tpu_torch, for A/B comparisons.

    python3 experiments/torch_ab.py ROOT TAG {int8,int4,int8_moe,int4_moe,k3,b13,b14,b5,b8} [check]

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
checked once against the plain version. ``int8_moe`` and ``int4_moe`` run
the all-expert kernel (``moe_launch``, a package that has it) instead:
``check`` at rows 1-9 and 64 of few-tile (E=2, OUT=128) and ragged, padded
(E=3, 520 x 1040) shapes with shared and per-expert x, then times at
Mixtral-8x7B's
gate/up (shared x) and down (per-expert x), cycling 2 stacked layers. ``k3``
times the fused KV write + flash decode at B=4, 32 query heads over 32, 16,
8 and 4 kv heads (1, 2, 4 and 8 per kv head), D=128 and 64, int8 and bf16
caches of 2048 rows at offsets 0/511/512/1999, cycling 4 layers, each shape
checked once against the plain version (output and written cache). ``b13``
times the calibration dequant (``kernels.dequant_launch``) at Llama-2-7B's
q, gate and down (2x8 g8, unit scales, cycling 4 copies of the codes), both
modes, each held bit-identical to ``dequant_plain``; its ``check`` first
runs K 1-8, g 3/4/8/12/16, S 16-256, with and without scales, against the
plain version. ``b14`` times the codebook gradient (``kernels.cb_grad_launch``)
at the groups of q, gate and down, K 2, S 256, g 8, both modes, each within
1e-5 of each segment's sum of |data| of a float64 sum; its ``check`` first
runs K 1-8, S 16-512, g 3/4/8/16 and G from 1 to 300000 the same way, and
reports whether two runs agree bitwise. ``b5`` times the dense W^T of the
codes-mode backward (``gather_prefill.dequant_wt_launch``) at Llama-2-7B's q,
gate and down (2x8, cycling 8 copies of the codes), bf16 and f32 out, each
held bit-identical to ``dequant_wt_plain``; its ``check`` first runs OUT
128/384/640 x IG 1/37 x K 1-8 at S 16 (and two runs bitwise equal). ``b8``
times the KV row write at the int8_short cache [32, 4, 32, 2048, 128],
offsets 0/511/512/1999: the one-array bf16 form and the four-array int8
form (``kv_write_inplace``, ``kv_write4_inplace``), each bit-identical to
``kv_write.plain``, with the wrapper's host time (``host_ms``, the median
of five runs of 200 calls) and the
floor of one CUDA-graph kernel node (a one-element ``fill_``,
``launch_floor_ms``); its ``check`` first runs B x H 1x1-8x64, D 4/64/128,
1-4 planes of mixed row widths and offsets -1 and S through
``kv_write.launch``. Compare two copies within one call on one card, in
turns (A, B, B, A). Exits non-zero on any mismatch.
"""
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import compare, host_ms, time_ms  # noqa: E402  (imports no aqlm_tpu_torch)

root, tag, kernel = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.abspath(root))
import torch  # noqa: E402

from aqlm_tpu_torch.ops import _build  # noqa: E402
from aqlm_tpu_torch.ops import flash_decode as fd  # noqa: E402
from aqlm_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from aqlm_tpu_torch.ops import int8_matmul as i8  # noqa: E402



def calib(kernel, check):
    """The b13 / b14 modes (see the docstring)."""
    from chip_smoke import CALIB_PROJS
    from aqlm_tpu_torch.ops import kernels as kn

    assert kn.__file__.startswith(os.path.abspath(root)), kn.__file__
    bad, res = 0, {}

    def b14_ok(codes, data, S, precise):
        got = kn.cb_grad_launch(codes, data, S, precise=precise)
        d64 = (data if precise else data.to(torch.bfloat16).float()).double()
        want = torch.zeros((codes.shape[1], S, data.shape[1]), dtype=torch.float64, device=dev)
        mass = torch.zeros_like(want)
        for k in range(codes.shape[1]):
            want[k].index_add_(0, codes[:, k].long(), d64)
            mass[k].index_add_(0, codes[:, k].long(), d64.abs())
        ok = bool(torch.isfinite(got).all()) and bool(((got.double() - want).abs() <= 1e-5 * mass).all())
        return ok, got

    if kernel == "b13":
        if check:
            for K, og, ig, g_, S in [(1, 129, 16, 8, 256), (2, 333, 37, 8, 256), (4, 65, 9, 16, 256),
                                     (8, 65, 9, 8, 256), (2, 31, 5, 4, 16), (2, 17, 6, 3, 256),
                                     (3, 40, 7, 8, 256), (2, 50, 4, 12, 64), (5, 7, 3, 5, 32)]:
                codes = torch.randint(0, S, (og, ig, K), generator=g, device=dev,
                                      dtype=torch.int32).to(torch.uint8)
                cb = torch.randn((K, S, g_), generator=g, device=dev)
                sc = torch.rand(og, generator=g, device=dev) + 0.5
                for scales in (None, sc):
                    for precise in (True, False):
                        ok = torch.equal(kn.dequant_launch(codes, cb, scales, precise=precise),
                                         kn.dequant_plain(codes, cb, scales, precise=precise))
                        bad += not ok
                        if not ok:
                            print("FAIL", K, og, ig, g_, S, scales is None, precise, flush=True)
            print(tag, "check bad", bad, flush=True)
        for name, out_f, in_f in CALIB_PROJS:
            ig = in_f // 8
            codes = torch.randint(0, 256, (4, out_f, ig, 2), generator=g, device=dev,
                                  dtype=torch.int32).to(torch.uint8)
            cb = torch.randn((2, 256, 8), generator=g, device=dev) / 4
            for precise in (True, False):
                bad += not torch.equal(kn.dequant_launch(codes[0], cb, precise=precise),
                                       kn.dequant_plain(codes[0], cb, precise=precise))
                res[f"{name}/{'precise' if precise else 'bf16'}"] = round(time_ms(
                    lambda i=0: kn.dequant_launch(codes[i % 4], cb, precise=precise), 20, 5), 5)
            del codes
            torch.cuda.empty_cache()
    else:
        if check:
            same = True
            for K, S, G, g_ in [(1, 16, 1001, 8), (2, 256, 77777, 8), (8, 256, 4099, 8),
                                (2, 512, 30001, 8), (3, 16, 513, 4), (2, 256, 300000, 16),
                                (5, 64, 20000, 3), (4, 256, 1, 8), (2, 256, 0, 8)]:
                codes = torch.randint(0, min(S, 256), (G, K), generator=g, device=dev,
                                      dtype=torch.int32).to(torch.uint8)
                data = torch.randn((G, g_), generator=g, device=dev)
                for precise in (True, False):
                    ok, got = b14_ok(codes, data, S, precise)
                    same = same and torch.equal(got, kn.cb_grad_launch(codes, data, S, precise=precise))
                    bad += not ok
                    if not ok:
                        print("FAIL", K, S, G, g_, precise, flush=True)
            print(tag, "check bad", bad, "reruns bitwise equal", same, flush=True)
        for name, out_f, in_f in CALIB_PROJS:
            G = out_f * in_f // 8
            codes = torch.randint(0, 256, (G, 2), generator=g, device=dev,
                                  dtype=torch.int32).to(torch.uint8)
            data = torch.randn((G, 8), generator=g, device=dev)
            for precise in (True, False):
                bad += not b14_ok(codes, data, 256, precise)[0]
                res[f"{name}/{'precise' if precise else 'bf16'}"] = round(time_ms(
                    lambda i=0: kn.cb_grad_launch(codes, data, 256, precise=precise), 20, 5), 5)
            del codes, data
            torch.cuda.empty_cache()
    print(tag, kernel, "bad", bad, json.dumps(res), flush=True)
    sys.exit(1 if bad else 0)


def b5(check):
    """The b5 mode (see the docstring)."""
    from chip_smoke import BWD_PROJS, N_LAYERS_TIMED
    from aqlm_tpu_torch.ops import gather_prefill as gp
    from aqlm_tpu_torch.ops import lut_gemv as lg

    assert gp.__file__.startswith(os.path.abspath(root)), gp.__file__
    bad, res = 0, {}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    if check:
        same = True
        for out_f in (128, 384, 640):
            for ig in (1, 37):
                for K in range(1, 9):
                    codes = lg.tile_codes(torch.randint(0, 16, (K, ig, out_f), generator=g, device=dev,
                                                        dtype=torch.int32).to(torch.uint8))
                    cb = torch.randn((K, 16, 8), generator=g, device=dev).to(torch.bfloat16)
                    sc = torch.rand(out_f, generator=g, device=dev) + 0.5
                    for dt in dtypes.values():
                        got = gp.dequant_wt_launch(codes, cb, sc, dt)
                        ok = torch.equal(got, gp.dequant_wt_plain(codes, cb, sc, dt))
                        same = same and torch.equal(got, gp.dequant_wt_launch(codes, cb, sc, dt))
                        bad += not ok
                        if not ok:
                            print("FAIL", out_f, ig, K, dt, flush=True)
        print(tag, "check bad", bad, "reruns bitwise equal", same, flush=True)
    for name, out_f, in_f in BWD_PROJS:
        tn = lg.lut_tile_n(out_f)
        codes = torch.randint(0, 256, (N_LAYERS_TIMED, out_f // tn, in_f // 8 * 2, tn), generator=g,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((2, 256, 8), generator=g, device=dev) / 4).to(torch.bfloat16)
        sc = torch.rand(out_f, generator=g, device=dev) + 0.5
        for dname, dt in dtypes.items():
            bad += not torch.equal(gp.dequant_wt_launch(codes[0], cb, sc, dt),
                                   gp.dequant_wt_plain(codes[0], cb, sc, dt))
            res[f"{name}/{dname}"] = round(time_ms(
                lambda i=0: gp.dequant_wt_launch(codes[i % N_LAYERS_TIMED], cb, sc, dt), 20, 5), 5)
            torch.cuda.empty_cache()
        del codes
    return bad, res


def b8(check):
    """The b8 mode (see the docstring)."""
    from aqlm_tpu_torch.ops import kv_write as kw

    assert kw.__file__.startswith(os.path.abspath(root)), kw.__file__
    bad, res = 0, {}
    if check:
        for b, h in ((1, 1), (2, 3), (4, 32), (8, 64)):
            for d in (4, 64, 128):
                for n in (1, 2, 3, 4):
                    S = 40
                    specs = [(torch.float16 if d == 4 else torch.bfloat16, d), (torch.int8, d),
                             (torch.float32, 1), (torch.uint8, 3)][:n]
                    caches = [torch.randint(-100, 100, (b, h, S, w), generator=g, device=dev,
                                            dtype=torch.int32).to(dt) for dt, w in specs]
                    news = [torch.randint(-100, 100, (b, h, w), generator=g, device=dev,
                                          dtype=torch.int32).to(dt) for dt, w in specs]
                    offsets = torch.tensor([S - 1, -1, S, 0, 17, 5, 39, 2][:b], dtype=torch.int32,
                                           device=dev)
                    want = [c.clone() for c in caches]
                    kw.plain(want, news, offsets)
                    kw.launch(caches, news, offsets)
                    ok = all(torch.equal(c, w) for c, w in zip(caches, want))
                    bad += not ok
                    if not ok:
                        print("FAIL", b, h, d, n, flush=True)
        print(tag, "check bad", bad, flush=True)
    L, B, H, S, D = 32, 4, 32, 2048, 128
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    for form in ("kv_write", "kv_write4"):
        if form == "kv_write":
            caches = [torch.randn((L, B, H, S, D), generator=g, device=dev).to(torch.bfloat16)]
            news = [torch.randn((B, H, 1, D), generator=g, device=dev).to(torch.bfloat16)]
            run = lambda i=0: kw.kv_write_inplace(caches[0], news[0], i % L, offsets)
        else:
            caches = [torch.randint(-127, 128, (L, B, H, S, D), generator=g, device=dev,
                                    dtype=torch.int32).to(torch.int8) for _ in range(2)] + [
                torch.rand((L, B, H, S, 1), generator=g, device=dev) for _ in range(2)]
            news = [torch.randint(-127, 128, (B, H, 1, D), generator=g, device=dev,
                                  dtype=torch.int32).to(torch.int8) for _ in range(2)] + [
                torch.rand((B, H, 1, 1), generator=g, device=dev) for _ in range(2)]
            run = lambda i=0: kw.kv_write4_inplace(*caches, *news, i % L, offsets)
        want = [c[3].clone() for c in caches]
        kw.plain(want, [n[:, :, 0] for n in news], offsets)
        run(3)
        bad += not all(torch.equal(c[3], w) for c, w in zip(caches, want))
        res[form] = round(time_ms(run, 50, 5), 6)
        res[f"{form}/host_ms"] = round(statistics.median(host_ms(run, 200) for _ in range(5)), 6)
        del caches, want
        torch.cuda.empty_cache()
    one = torch.zeros(1, device=dev)
    res["launch_floor_ms"] = round(time_ms(lambda i=0: one.fill_(1.0), 50, 5), 6)
    return bad, res


if kernel in ("b13", "b14", "b5", "b8"):
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if kernel in ("b13", "b14"):
        calib(kernel, len(sys.argv) > 4)
    bad, res = (b5 if kernel == "b5" else b8)(len(sys.argv) > 4)
    print(tag, kernel, "bad", bad, json.dumps(res), flush=True)
    sys.exit(1 if bad else 0)

m = i8 if kernel in ("int8", "int8_moe") else i4
moe = kernel.endswith("_moe")
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
    if m is i8:
        lead = (n, experts) if experts else (n,)
        w8 = torch.randint(-127, 128, (*lead, out_f, i8.pad_in_features(in_f)), generator=g,
                           device=dev, dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        return w8, torch.rand((*lead, out_f), generator=g, device=dev) / (127 * in_f ** 0.5)
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
