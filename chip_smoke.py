#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aqlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printed as JSON lines; any failure exits non-zero:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the time to build the CUDA kernels from csrc/;
2. checks: each kernel (K1 LUT-GEMV, K2 gather-prefill, K3 fused KV write +
   flash decode, the W8A16 int8 matmul, the W4A16 int4 matmul, the
   all-expert W8A16 and W4A16 MoE matmuls, and B15, the dequant-matmul
   over untiled codes) against its plain PyTorch version on the card, at
   the shapes of the serving paths (K1 at every decode batch bucket of
   phase 4's ServeConfig, K2 at every prefill bucket, both also at
   Falcon-7B's fc1, the int8 kernel at both for Llama-2-7B's four
   projections and the lm_head, the int4 kernel at both for the four
   projections, each MoE kernel at both for Mixtral-8x7B's gate/up, shared
   x, and down, per-expert x, B15 at both for Falcon-7B's q, k, v, o and
   fc2, K3 at Llama-2-7B's 32 kv heads and at Falcon-7B's 71 query heads
   over one), with its time, the plain version's time, the least time the
   card could take (bound) and, where one PyTorch call computes the same
   function, its time (for a MoE kernel with per-expert x, where none does,
   the sum of one call per expert, as an aside);
3. reference: a 2-layer model at full Llama-2-7B width, in codes mode, in
   int8 mode (int8 lm_head) and in int4 mode (dense head), a 2-layer
   Mixtral-8x7B in int8 mode (int8 lm_head) and in int4 mode (dense head),
   and a 2-layer Falcon-7B in codes mode (gated with a bf16 KV cache, the
   int8 one beside it; see ``reference_check``), kernels on the card against
   the plain versions on the CPU, prefill and decode logits;
4. engine: six Engine.generate runs at full width and depth (32 layers,
   random weights from a seed, int8 KV cache) on 6 prompts of 64-1500
   tokens, 64 new tokens each, greedy: Llama-2-7B in 2x8 codes, in int8
   with the int8 lm_head and in int4 with the dense head, then
   Mixtral-8x7B in int8 with the int8 lm_head and in int4 with the dense
   head, both loaded with donate_params, then Falcon-7B in 2x8 codes (each
   engine is freed before the next is built). Launch counts are reset
   before and read after each run; each run must launch the kernels of its
   own path and none of the others', a Mixtral run its MoE kernel 3 times
   per layer per forward, and the Falcon run B15 5 times per K1/K2 launch
   (q/k/v/o/fc2 against fc1);
5. the seconds of each phase, the kernel list, then {"ok": true, "device":
   {...}} as the last line.

Writes chiprun_out/chip_smoke.json with every record and
chiprun_out/ptxas.txt with the kernels' register and shared-memory report.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
RECORDS = []
T_START = time.perf_counter()


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def time_ms(fn, iters: int, repeats: int = 3) -> float:
    """Device time of one call: ``iters`` calls are captured in a CUDA graph,
    so the Python wrapper's own time is left out, and the replay is timed
    with CUDA events; median over ``repeats`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)  # warm-up outside the capture (allocator, first-use attribute calls)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(out)


def host_ms(fn, iters: int = 50) -> float:
    """Host time to issue one call (the wrapper's Python and launch), no sync inside."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def compare(got: torch.Tensor, want: torch.Tensor, steps: int = 1) -> dict:
    """bf16 outputs: |got - want| <= steps * 2^-7 |want| + 1e-3 max|want|
    elementwise: both sides round an f32 sum to bf16, and sums taken in
    another order may round to neighbouring bf16 values, one step apart per
    rounding point. B15 has two (the product, then the scaled product, as
    the TPU kernel rounds), so its results may lie two steps apart."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = float(w.abs().max())
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= steps * 2.0 ** -7 * w.abs() + 1e-3 * scale).all())
    return {"max_abs_err": float(err.max()), "max_rel_err": float(err.max()) / max(scale, 1e-30),
            "tol": f"{steps}*2^-7*|plain| + 1e-3*max|plain|", "ok": ok}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at Llama-2-7B shapes
# ---------------------------------------------------------------------------

# (name, parts' out_features, in_features): the four decode/prefill launches of a block
PROJS = [("qkv", (4096, 4096, 4096), 4096), ("o", (4096,), 4096),
         ("gate_up", (11008, 11008), 4096), ("down", (4096,), 11008),
         ("falcon_fc1", (18176,), 4544)]  # Falcon-7B's one tiled projection
N_LAYERS_TIMED = 8  # stacked copies cycled while timing, so the codes come from HBM


def _proj_inputs(gen, sizes, in_f, dev):
    from aqlm_tpu_torch.ops.lut_gemv import lut_tile_n, proj_map_for

    tn = min(lut_tile_n(s) for s in sizes)
    nt, kig, P = sum(sizes) // tn, in_f // 8 * 2, len(sizes)
    codes = torch.randint(0, 256, (N_LAYERS_TIMED, nt, kig, tn), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    cb = (torch.randn((N_LAYERS_TIMED, P, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
    scales = torch.rand((N_LAYERS_TIMED, sum(sizes)), generator=gen, device=dev) + 0.5
    pm = proj_map_for(sizes, tn, dev) if P > 1 else None
    return codes, cb, scales, pm, (nt, kig, tn, P)


def _codes_bytes(rows, out_f, in_f, P, nt, kig, tn):
    return nt * kig * tn + rows * in_f * 2 + rows * out_f * 2 + P * 2 * 256 * 8 * 2 + out_f * 4


def main_path_rows(serve) -> tuple[list, list]:
    """(decode, prefill): the row counts the Engine hands a projection's
    kernel under ``serve``. Decode: the batch buckets (powers of two up to
    max_batch) plus the decode kernels' largest batch; prefill: every
    prefill bucket, clamped to max_len as the Engine clamps it. K1 takes the
    decode rows, K2 the prefill rows, the int8 kernel both."""
    from aqlm_tpu_torch.ops.lut_gemv import LUT_GEMV_MAX_BATCH

    decode, b = set(), 1
    while b < serve.max_batch:
        decode.add(b)
        b *= 2
    decode |= {serve.max_batch, LUT_GEMV_MAX_BATCH}
    prefill = {min(t, serve.max_len) for t in serve.prefill_buckets}
    return sorted(decode), sorted(prefill)


def check_k1_k2(gen, dev, failures):
    from aqlm_tpu_torch.ops import gather_prefill as gp
    from aqlm_tpu_torch.ops import lut_gemv as lg

    reps = {}
    decode, prefill = main_path_rows(engine_serve_config("codes"))
    rows_of = {"lut_gemv": decode, "gather_prefill": prefill}
    rep_rows = {"lut_gemv": 4, "gather_prefill": max(rows_of["gather_prefill"])}
    for name, sizes, in_f in PROJS:
        codes, cb, scales, pm, (nt, kig, tn, P) = _proj_inputs(gen, sizes, in_f, dev)
        out_f = sum(sizes)
        for kernel, rows_list in rows_of.items():
            for rows in rows_list:
                x = torch.randn((N_LAYERS_TIMED, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
                if kernel == "lut_gemv":
                    run = lambda i=0: lg.launch(x[i % N_LAYERS_TIMED], codes[i % N_LAYERS_TIMED],
                                                 cb[i % N_LAYERS_TIMED], scales[i % N_LAYERS_TIMED],
                                                 pm, torch.bfloat16, 8)
                    plain = lambda i=0: lg.plain(x[0], codes[0], cb[0], scales[0], pm, torch.bfloat16)
                else:
                    run = lambda i=0: gp.launch(x[i % N_LAYERS_TIMED], codes[i % N_LAYERS_TIMED],
                                                 cb[i % N_LAYERS_TIMED], scales[i % N_LAYERS_TIMED],
                                                 pm, 8)
                    plain = lambda i=0: gp.plain(x[0], codes[0], cb[0], scales[0], pm)
                cmp = compare(run(0), plain(0))
                ms = time_ms(run, 50)
                plain_ms = time_ms(plain, 3)
                b_ms, b_by = bound(_codes_bytes(rows, out_f, in_f, P, nt, kig, tn),
                                   2.0 * rows * out_f * in_f)
                rec = {"phase": "check", "kernel": kernel, "proj": name, "rows": rows,
                       "out_features": out_f, "in_features": in_f, "tn": tn, **cmp,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None, "host_ms": host_ms(run)}
                emit(rec)
                if not cmp["ok"]:
                    failures.append(rec)
                if name == "qkv" and rows == rep_rows[kernel]:
                    reps[kernel] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


# (name, out_features, in_features): the int8 path's launches of a block, and its head
INT8_PROJS = [("qkv", 12288, 4096), ("o", 4096, 4096), ("gate_up", 22016, 4096),
              ("down", 4096, 11008), ("lm_head", 32000, 4096)]


def check_int8(gen, dev, failures):
    from aqlm_tpu_torch.ops import int8_matmul as im

    reps = {}
    for name, out_f, in_f in INT8_PROJS:
        ld = im.pad_in_features(in_f)
        w8 = torch.randint(-127, 128, (N_LAYERS_TIMED, out_f, ld), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0  # aqlm_tpu's padding columns
        scale = torch.rand((N_LAYERS_TIMED, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        # yardstick only: PyTorch's W8A16 op takes [OUT, IN] weights and bf16 scales
        w_lib = w8[..., :in_f].contiguous()
        s_lib = scale.to(torch.bfloat16)
        for rows in sum(main_path_rows(engine_serve_config("int8")), []):
            x = torch.randn((N_LAYERS_TIMED, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: im.launch(x[i % N_LAYERS_TIMED], w8[i % N_LAYERS_TIMED],
                                        scale[i % N_LAYERS_TIMED])
            plain = lambda i=0: im.plain(x[0], w8[0], scale[0])
            cmp = compare(run(0), plain(0))
            ms = time_ms(run, 50)
            plain_ms = time_ms(plain, 3)
            b_ms, b_by = bound(out_f * in_f + rows * in_f * 2 + rows * out_f * 2 + out_f * 4,
                               2.0 * rows * out_f * in_f)
            library_ms = library_error = None
            try:
                library = lambda i=0: torch._weight_int8pack_mm(
                    x[i % N_LAYERS_TIMED], w_lib[i % N_LAYERS_TIMED], s_lib[i % N_LAYERS_TIMED])
                library_ms = time_ms(library, 50 if rows <= 8 else 10)
            except Exception as exc:  # the yardstick only: recorded, never on the port's path
                library_error = str(exc).strip().splitlines()[0][:200]
            rec = {"phase": "check", "kernel": "int8_matmul", "proj": name, "rows": rows,
                   "out_features": out_f, "in_features": in_f, "row_stride": ld, **cmp,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "torch._weight_int8pack_mm", "library_ms": library_ms,
                   "library_error": library_error, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "qkv" and rows == 4:
                reps["int8_matmul"] = rec
        del w8, scale, w_lib, s_lib
        torch.cuda.empty_cache()
    return reps


# (name, out_features, in_features): the int4 path's launches of a block (its head is dense)
INT4_PROJS = INT8_PROJS[:4]


def _int4_library(w4, gscale, in_f):
    """The same q and s in the layout of PyTorch's tinygemm W4A16 op: [OUT, IN]
    q with adjacent columns paired in a byte, then ``_convert_weight_to_int4pack``;
    bf16 (scale, zero) pairs [IN/128, OUT, 2] with zero 0 (its dequant is
    (q - 8) * scale + zero)."""
    from aqlm_tpu_torch.ops import int4_matmul as i4

    q = i4.unpack_int4(w4).reshape(w4.shape[0], -1)[:, :in_f]
    packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
    w_lib = torch._convert_weight_to_int4pack(packed, 8)
    g = -(-in_f // i4.GROUP)
    sz = torch.stack([gscale[:g], torch.zeros_like(gscale[:g])], dim=-1).to(torch.bfloat16)
    return w_lib, sz.contiguous()


def check_int4(gen, dev, failures):
    from aqlm_tpu_torch.ops import int4_matmul as i4

    reps = {}
    for name, out_f, in_f in INT4_PROJS:
        packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev) * in_f ** -0.5)
                 for _ in range(N_LAYERS_TIMED)]
        w4 = torch.stack([p[0] for p in packs])
        gs = torch.stack([p[1] for p in packs])
        del packs
        library_error = None
        try:  # yardstick only: recorded, never on the port's path
            lib_args = [_int4_library(w4[i], gs[i], in_f) for i in range(N_LAYERS_TIMED)]
        except Exception as exc:
            lib_args, library_error = None, str(exc).strip().splitlines()[0][:200]
        for rows in sum(main_path_rows(engine_serve_config("int4")), []):
            x = torch.randn((N_LAYERS_TIMED, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: i4.launch(x[i % N_LAYERS_TIMED], w4[i % N_LAYERS_TIMED],
                                        gs[i % N_LAYERS_TIMED])
            plain = lambda i=0: i4.plain(x[0], w4[0], gs[0])
            cmp = compare(run(0), plain(0))
            ms = time_ms(run, 50)
            plain_ms = time_ms(plain, 3)
            n_groups = -(-in_f // i4.GROUP)
            b_ms, b_by = bound(out_f * in_f // 2 + 4 * out_f * n_groups + rows * in_f * 2
                               + rows * out_f * 2, 2.0 * rows * out_f * in_f)
            library_ms, rec_error = None, library_error
            if lib_args is not None:
                try:
                    library = lambda i=0: torch._weight_int4pack_mm(
                        x[i % N_LAYERS_TIMED], lib_args[i % N_LAYERS_TIMED][0], i4.GROUP,
                        lib_args[i % N_LAYERS_TIMED][1])
                    library_ms = time_ms(library, 50 if rows <= 8 else 10)
                except Exception as exc:
                    rec_error = str(exc).strip().splitlines()[0][:200]
            rec = {"phase": "check", "kernel": "int4_matmul", "proj": name, "rows": rows,
                   "out_features": out_f, "in_features": in_f, "row_bytes": w4.shape[-1], **cmp,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "torch._weight_int4pack_mm", "library_ms": library_ms,
                   "library_error": rec_error, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "qkv" and rows == 4:
                reps["int4_matmul"] = rec
        del w4, gs, lib_args
        torch.cuda.empty_cache()
    return reps


# (name, experts, out_features, in_features, x per expert): Mixtral-8x7B's
# all-expert launches of a block (up has gate's shape)
MOE_PROJS = [("gate_up", 8, 14336, 4096, False), ("down", 8, 4096, 14336, True)]


def check_int8_moe(gen, dev, failures):
    from aqlm_tpu_torch.ops import int8_matmul as im

    reps = {}
    L = 2  # two stacked layers cycled: one launch reads 470 MB, past the 50 MB L2
    for name, E, out_f, in_f, per_expert in MOE_PROJS:
        w8 = torch.randint(-127, 128, (L, E, out_f, im.pad_in_features(in_f)), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        scale = torch.rand((L, E, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        w_lib = w8[..., :in_f].contiguous()
        s_lib = scale.to(torch.bfloat16)
        for rows in sum(main_path_rows(engine_serve_config("mixtral_int8")), []):
            shape = (L, E, rows, in_f) if per_expert else (L, rows, in_f)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: im.moe_launch(x[i % L], w8[i % L], scale[i % L])
            plain = lambda i=0: im.moe_plain(x[0], w8[0], scale[0])
            cmp = compare(run(0), plain(0))
            ms = time_ms(run, 20 if rows <= 8 else 5)
            plain_ms = time_ms(plain, 2)
            b_ms, b_by = bound(E * out_f * in_f + x[0].numel() * 2 + E * rows * out_f * 2
                               + E * out_f * 4, 2.0 * E * rows * out_f * in_f)
            iters, repeats = (10, 3) if rows <= 8 else (1, 1)
            library_ms = aside_ms = library_error = None
            try:  # yardsticks only: recorded, never on the port's path
                if per_expert:
                    # no single PyTorch call takes a different x per expert: an
                    # aside, not the library column, of one W8A16 call per expert
                    aside = lambda i=0: [torch._weight_int8pack_mm(
                        x[i % L][e], w_lib[i % L, e], s_lib[i % L, e]) for e in range(E)]
                    aside_ms = time_ms(aside, iters, repeats)
                else:
                    # shared x: one call over all experts' rows; its [N, E*OUT]
                    # is the kernel's [E, N, OUT] transposed
                    library = lambda i=0: torch._weight_int8pack_mm(
                        x[i % L], w_lib[i % L].view(E * out_f, in_f), s_lib[i % L].view(E * out_f))
                    library_ms = time_ms(library, iters, repeats)
            except Exception as exc:
                library_error = str(exc).strip().splitlines()[0][:200]
            lib = ({"aside": f"{E} x torch._weight_int8pack_mm, one per expert", "aside_ms": aside_ms}
                   if per_expert else {"library": "torch._weight_int8pack_mm over E*OUT rows"})
            rec = {"phase": "check", "kernel": "int8_moe_matmul", "proj": name, "experts": E,
                   "rows": rows, "out_features": out_f, "in_features": in_f,
                   "x": "per expert" if per_expert else "shared", **cmp,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "none", "library_ms": library_ms, **lib,
                   "library_error": library_error, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "gate_up" and rows == 4:
                reps["int8_moe_matmul"] = rec
        del w8, scale, w_lib, s_lib
        torch.cuda.empty_cache()
    return reps


def check_int4_moe(gen, dev, failures):
    from aqlm_tpu_torch.ops import int4_matmul as i4

    reps = {}
    L = 2  # two stacked layers cycled: one launch reads 250 MB, past the 50 MB L2
    for name, E, out_f, in_f, per_expert in MOE_PROJS:
        packs = [i4.quantize_int4(torch.randn((out_f, in_f), generator=gen, device=dev) * in_f ** -0.5)
                 for _ in range(L * E)]
        w4 = torch.stack([p[0] for p in packs]).reshape(L, E, out_f, -1)
        gs = torch.stack([p[1] for p in packs]).reshape(L, E, -1, out_f)
        del packs
        n_groups = gs.shape[2]
        library_error = None
        try:  # yardsticks only: recorded, never on the port's path
            if per_expert:  # one packed weight per expert
                lib_args = [[_int4_library(w4[l, e], gs[l, e], in_f) for e in range(E)]
                            for l in range(L)]
            else:  # all experts' rows in one weight: [E*OUT, ...]
                lib_args = [_int4_library(w4[l].reshape(E * out_f, -1),
                                          gs[l].permute(1, 0, 2).reshape(n_groups, E * out_f), in_f)
                            for l in range(L)]
        except Exception as exc:
            lib_args, library_error = None, str(exc).strip().splitlines()[0][:200]
        for rows in sum(main_path_rows(engine_serve_config("mixtral_int4")), []):
            shape = (L, E, rows, in_f) if per_expert else (L, rows, in_f)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: i4.moe_launch(x[i % L], w4[i % L], gs[i % L])
            plain = lambda i=0: i4.moe_plain(x[0], w4[0], gs[0])
            cmp = compare(run(0), plain(0))
            ms = time_ms(run, 20 if rows <= 8 else 5)
            plain_ms = time_ms(plain, 2)
            b_ms, b_by = bound(E * out_f * in_f // 2 + E * n_groups * out_f * 4 + x[0].numel() * 2
                               + E * rows * out_f * 2, 2.0 * E * rows * out_f * in_f)
            iters, repeats = (10, 3) if rows <= 8 else (2, 1)
            library_ms = aside_ms = None
            rec_error = library_error
            if lib_args is not None:
                try:
                    if per_expert:
                        # no single PyTorch call takes a different x per expert: an
                        # aside, not the library column, of one W4A16 call per expert
                        aside = lambda i=0: [torch._weight_int4pack_mm(
                            x[i % L][e], lib_args[i % L][e][0], i4.GROUP, lib_args[i % L][e][1])
                            for e in range(E)]
                        aside_ms = time_ms(aside, iters, repeats)
                    else:
                        # shared x: one call over all experts' rows; its [N, E*OUT]
                        # is the kernel's [E, N, OUT] transposed
                        library = lambda i=0: torch._weight_int4pack_mm(
                            x[i % L], lib_args[i % L][0], i4.GROUP, lib_args[i % L][1])
                        library_ms = time_ms(library, iters, repeats)
                except Exception as exc:
                    rec_error = str(exc).strip().splitlines()[0][:200]
            lib = ({"aside": f"{E} x torch._weight_int4pack_mm, one per expert", "aside_ms": aside_ms}
                   if per_expert else {"library": "torch._weight_int4pack_mm over E*OUT rows"})
            rec = {"phase": "check", "kernel": "int4_moe_matmul", "proj": name, "experts": E,
                   "rows": rows, "out_features": out_f, "in_features": in_f,
                   "x": "per expert" if per_expert else "shared", **cmp,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "none", "library_ms": library_ms, **lib,
                   "library_error": rec_error, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "gate_up" and rows == 4:
                reps["int4_moe_matmul"] = rec
        del w4, gs, lib_args
        torch.cuda.empty_cache()
    return reps


# (name, out_features, in_features): Falcon-7B's launches of B15 in a block
ONEHOT_PROJS = [("q", 4544, 4544), ("k", 64, 4544), ("v", 64, 4544), ("o", 4544, 4544),
                ("fc2", 4544, 18176)]


def check_onehot(gen, dev, failures):
    from aqlm_tpu_torch.ops import kernels as k15

    reps = {}
    for name, out_f, in_f in ONEHOT_PROJS:
        K, ig = 2, in_f // 8
        codes = torch.randint(0, 256, (N_LAYERS_TIMED, K, ig, out_f), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((N_LAYERS_TIMED, K, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((N_LAYERS_TIMED, out_f), generator=gen, device=dev) + 0.5
        for rows in sum(main_path_rows(engine_serve_config("falcon_codes")), []):
            x = torch.randn((N_LAYERS_TIMED, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: k15.launch(x[i % N_LAYERS_TIMED], codes[i % N_LAYERS_TIMED],
                                         cb[i % N_LAYERS_TIMED], scales[i % N_LAYERS_TIMED], 8)
            plain = lambda i=0: k15.plain(x[0], codes[0], cb[0], scales[0])
            cmp = compare(run(0), plain(0), steps=2)
            ms = time_ms(run, 50)
            plain_ms = time_ms(plain, 3)
            b_ms, b_by = bound(K * ig * out_f + rows * in_f * 2 + rows * out_f * 2 + K * 256 * 8 * 2
                               + out_f * 4, 2.0 * rows * out_f * in_f)
            # no one PyTorch call computes a codes dequant-matmul: no library column
            rec = {"phase": "check", "kernel": "onehot_matmul", "proj": name, "rows": rows,
                   "out_features": out_f, "in_features": in_f, **cmp, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library": "none",
                   "library_ms": None, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "q" and rows == 4:
                reps["onehot_matmul"] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


# (model, kv heads, query heads per kv head, head_dim): K3's decode shapes
K3_SHAPES = [("llama2_7b", 32, 1, 128), ("falcon_7b", 1, 71, 64)]


def check_k3(gen, dev, failures):
    from aqlm_tpu_torch.ops import flash_decode as fd

    L, B, S = 4, 4, 2048
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)  # 0 and a 512 edge
    reps = {}
    for (model, H, rep, D), quant, window in itertools.product(K3_SHAPES, (True, False),
                                                               (None, 256)):
        q = torch.randn((B, 1, H * rep, D), generator=gen, device=dev).to(torch.bfloat16)
        if quant:
            kv = [torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
            sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
            new = [torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int8) for _ in range(2)]
            nsc = [torch.rand((B, 1, H, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        else:
            kv = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            sc, nsc = [None, None], [None, None]
            new = [torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2)]
        ref_kv = [t.clone() for t in kv]
        ref_sc = [None if t is None else t.clone() for t in sc]
        run = lambda i=0: fd.flash_decode_write_attention_indexed(
            q, new[0], new[1], kv[0], kv[1], sc[0], sc[1], i % L, offsets,
            k_scale_new=nsc[0], v_scale_new=nsc[1], window=window)[0]
        q_hm = q.reshape(B, H, rep, D)
        nk, nv = new[0][:, 0].contiguous(), new[1][:, 0].contiguous()
        nks = None if nsc[0] is None else nsc[0][:, 0, :, 0].contiguous()
        nvs = None if nsc[1] is None else nsc[1][:, 0, :, 0].contiguous()
        plain = lambda i=0: fd.plain(
            q_hm, nk, nv, nks, nvs, ref_kv[0][0], ref_kv[1][0],
            None if ref_sc[0] is None else ref_sc[0][0],
            None if ref_sc[1] is None else ref_sc[1][0], offsets, D ** -0.5, window)
        cmp = compare(run(0).reshape(B, H, rep, D), plain(0))
        cmp["ok"] = cmp["ok"] and bool((kv[0][0] == ref_kv[0][0]).all()) and bool(
            (kv[1][0] == ref_kv[1][0]).all())
        ms = time_ms(run, 50)
        plain_ms = time_ms(plain, 5)
        keys = [min(int(o) + 1, window or S) for o in offsets.tolist()]
        row_bytes = 2 * (D + 4) if quant else 2 * 2 * D
        nbytes = sum(keys) * H * row_bytes + 2 * B * H * rep * D * 2 + B * H * row_bytes + B * 4
        b_ms, b_by = bound(nbytes, sum(keys) * H * rep * 4.0 * D)
        library_ms = None
        if not quant:
            # yardstick only: one SDPA call over the same bf16 cache and lengths
            pos = torch.arange(S, device=dev)
            lens = (offsets + 1)[:, None]
            lo = (lens - window) if window else torch.zeros_like(lens)
            mask = ((pos[None] < lens) & (pos[None] >= lo))[:, None, None, :]
            sdpa = lambda i=0: torch.nn.functional.scaled_dot_product_attention(
                q_hm, kv[0][i % L], kv[1][i % L], attn_mask=mask)
            library_ms = time_ms(sdpa, 50)
        rec = {"phase": "check", "kernel": "flash_decode_write", "model": model,
               "kv": "int8" if quant else "bf16", "window": window, "B": B, "Hkv": H, "rep": rep,
               "D": D, "max_len": S, "offsets": offsets.tolist(), **cmp, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
               "host_ms": host_ms(run)}
        emit(rec)
        if not cmp["ok"]:
            failures.append(rec)
        if model == "llama2_7b" and quant and window is None:
            reps["flash_decode_write"] = rec
        del kv, sc, ref_kv, ref_sc
        torch.cuda.empty_cache()
    return reps


# ---------------------------------------------------------------------------
# phase 3: small-depth reference, kernels on the card vs plain on the CPU
# ---------------------------------------------------------------------------

def _to(node, dev):
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _to(getattr(node, f.name), dev) for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    return node


def _reference_logits(st, cfg2, ids, max_len, quantized, d):
    """Last-position logits of a 20-token prefill and 3 decode steps on ``d``."""
    from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache

    cache = init_kv_cache(cfg2, 1, max_len, quantized=quantized, device=d)
    logits = []
    with torch.inference_mode():
        x = torch.from_numpy(ids).to(d)
        lg, _ = forward_stacked(st, cfg2, x[:, :20], cache=cache, cache_offset=0)
        logits.append(lg[0, -1])
        for p in range(20, 23):
            lg, _ = forward_stacked(st, cfg2, x[:, p:p + 1], cache=cache, cache_offset=p)
            logits.append(lg[0, -1])
    return torch.stack(logits).float().cpu()


def reference_check(dev, run):
    """Codes (Llama or Falcon): max_len 256 (flash decode: K3 on the card, its
    plain version on the CPU). int8 (with the int8 lm_head) and int4 (dense head), Llama or
    Mixtral: max_len 1024, where the flash rule takes their layers too.

    The KV cache is int8, but Falcon's gated comparison runs with a bf16
    cache and reports the int8 one beside it, ungated: its one kv head
    serves all 71 query heads, so a key whose int8 rounding flips between two
    summation orders moves every head's attention at once. On the CPU alone,
    summing the projections in another order moves this model's logits by
    1.7% of the largest with an int8 cache and 0.45% with a bf16 one
    (Llama-2-7B: 0.65% with either; experiments/torch_falcon_kv_sensitivity.py)."""
    from aqlm_tpu_torch.config import SCHEME_2X8
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.serve import ServeConfig
    from aqlm_tpu_torch.serve.engine import serving_params

    model, mode = RUNS[run]
    cfg = model_config(model)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(1), cfg2, SCHEME_2X8,
                                     mode=mode)
    serve = ServeConfig(lm_head_int8=mode == "int8")
    max_len = 256 if mode == "codes" else 1024
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 23))
    kv_modes = ("bf16", "int8") if model == "falcon_7b" else ("int8",)  # the first is gated
    outs = {}
    for d in (dev, torch.device("cpu")):
        st = serving_params(_to(params, d), cfg2, serve)
        for kv in kv_modes:
            outs[d.type, kv] = _reference_logits(st, cfg2, ids, max_len, kv == "int8", d)
    res = {}
    for kv in kv_modes:
        got, want = outs["cuda", kv], outs["cpu", kv]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        res[kv] = {"max_abs_err": err, "max_rel_err": err / scale,
                   "argmax_agree": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                   "ok": bool(torch.isfinite(got).all()) and err <= 3e-2 * scale}
    kv = kv_modes[0]
    aside = {"int8_kv_aside": res["int8"]} if kv != "int8" else {}
    return {"phase": "reference", "run": run, "model": model, "mode": mode,
            "lm_head_int8": serve.lm_head_int8, "layers": 2,
            "hidden": cfg.hidden_size, "max_len": max_len, "prefill_tokens": 20,
            "decode_steps": 3, "kv": kv, **res[kv],
            "tol": "max|cuda - cpu| <= 3e-2 * max|cpu|", **aside}


# ---------------------------------------------------------------------------
# phase 4: Engine.generate at full Llama-2-7B width and depth
# ---------------------------------------------------------------------------

# run -> (model, mode): the engine runs, in order
RUNS = {"codes": ("llama2_7b", "codes"), "int8": ("llama2_7b", "int8"),
        "int4": ("llama2_7b", "int4"), "mixtral_int8": ("mixtral_8x7b", "int8"),
        "mixtral_int4": ("mixtral_8x7b", "int4"), "falcon_codes": ("falcon_7b", "codes")}
# the kernels each engine run must launch; the other paths' must stay at 0
PATH_KERNELS = {"codes": ("lut_gemv", "gather_prefill", "flash_decode_write"),
                "int8": ("int8_matmul", "flash_decode_write"),
                "int4": ("int4_matmul", "flash_decode_write"),
                "mixtral_int8": ("int8_matmul", "int8_moe_matmul", "flash_decode_write"),
                "mixtral_int4": ("int4_matmul", "int4_moe_matmul", "flash_decode_write"),
                "falcon_codes": ("lut_gemv", "gather_prefill", "onehot_matmul",
                                 "flash_decode_write")}


def model_config(model):
    from aqlm_tpu_torch.models.falcon import FalconConfig
    from aqlm_tpu_torch.models.llama import ModelConfig
    from aqlm_tpu_torch.models.mixtral import MixtralConfig

    return {"llama2_7b": ModelConfig.llama2_7b, "mixtral_8x7b": MixtralConfig.mixtral_8x7b,
            "falcon_7b": FalconConfig.falcon_7b}[model]()


def engine_serve_config(run):
    """Mixtral's 43.6 GiB of int8 weights load with donate_params: without it
    the stacked copies would double them past the card's 80 GB (its ~24 GB
    in int4 load the same way)."""
    from aqlm_tpu_torch.serve import ServeConfig

    model, mode = RUNS[run]
    return ServeConfig(max_batch=4, max_len=2048, kv_quantized=True, lm_head_int8=mode == "int8",
                       donate_params=model == "mixtral_8x7b")


def engine_run(dev, run):
    from aqlm_tpu_torch.config import SCHEME_2X8
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import Engine, SamplingParams

    model, mode = RUNS[run]
    cfg = model_config(model)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg, SCHEME_2X8,
                                     mode=mode)
    serve = engine_serve_config(run)
    engine = Engine(params, cfg, serve)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()

    lengths = [64, 200, 700, 1100, 1500, 333]  # 1100 and 1500 prefill in chunks of 1024
    rng = np.random.default_rng(0)
    warm = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    # prefill throughput: the same lengths, other tokens, one new token each
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(warm, SamplingParams(max_new_tokens=1))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    # the main path: every launch count is read over exactly this call
    steps = []
    inner_step = engine.step

    def timed_step():
        n_pending = len(engine._pending)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        emitted = inner_step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - s0, len(engine._pending) == n_pending, len(emitted)))
        return emitted

    engine.step = timed_step
    new_tokens = 64
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, SamplingParams(max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in _build.KERNELS.items()}

    ok = all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size for t in o) for o in out)
    ran = all(launches[k] > 0 for k in PATH_KERNELS[run])
    others = all(n == 0 for k, n in launches.items() if k not in PATH_KERNELS[run])
    per_forward = {}
    if model == "mixtral_8x7b":
        # every forward: fused qkv and o per layer (plus the int8 head) on the
        # mode's dense kernel, gate, up and down per layer on its MoE kernel
        dense = f"{mode}_matmul"
        forwards = launches[dense] / (2 * cfg.num_layers + serve.lm_head_int8)
        per_forward = {"forwards": forwards,
                       "moe_launches_per_forward": launches[f"{mode}_moe_matmul"] / forwards}
        ran = ran and per_forward["moe_launches_per_forward"] == 3 * cfg.num_layers
    if model == "falcon_7b":
        # every forward: fc1 per layer on K1 or K2, q/k/v/o/fc2 per layer on B15
        per_forward = {"onehot_per_fc1_launch": launches["onehot_matmul"]
                       / (launches["lut_gemv"] + launches["gather_prefill"])}
        ran = ran and per_forward["onehot_per_fc1_launch"] == 5
    decode_steps = [s for s in steps if s[1] and s[2] > 0]
    decode_tok = sum(s[2] for s in decode_steps)
    decode_s = sum(s[0] for s in decode_steps)
    rec = {"phase": "engine", "run": run, "model": model, "layers": cfg.num_layers,
           "scheme": "2x8g8", "mode": mode, "lm_head_int8": serve.lm_head_int8,
           "donate_params": serve.donate_params, "kv": "int8",
           "max_batch": serve.max_batch, "max_len": serve.max_len,
           "prompt_lengths": lengths, "new_tokens": new_tokens, "build_s": build_s,
           "prefill_tok_s": sum(lengths) / prefill_s, "prefill_s": prefill_s,
           "decode_tok_s": decode_tok / decode_s if decode_s else None,
           "decode_steps_timed": len(decode_steps), "decode_tokens_timed": decode_tok,
           "generate_s": total_s, "steps": len(steps),
           "build_peak_mem_gib": build_peak_gib,
           "serve_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, **per_forward, "prefix_hits": engine.prefix_stats["hits"],
           "first_tokens": [o[:4] for o in out], "ok": ok and ran and others}
    rec["profile"] = profile_decode(engine, cfg, rng)
    del engine.step  # the timing wrapper closes over the engine: a cycle that would keep it alive
    del engine
    torch.cuda.empty_cache()
    return rec


def profile_decode(engine, cfg, rng) -> dict:
    """Device time by kernel over a short decode window (4 rows of 64-token
    prompts, 16 new tokens), from torch.profiler, beside its wall time."""
    from torch.profiler import ProfilerActivity, profile

    from aqlm_tpu_torch.serve import SamplingParams

    prompts = [rng.integers(0, cfg.vocab_size, 64) for _ in range(4)]
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompts, SamplingParams(max_new_tokens=16))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # device-side entries only: an aten op's entry repeats its kernels' time
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    # the host side: torch ops by their own CPU time (the profiler's overhead included)
    host = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CPU]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"window": "4 x 64-token prompts, 16 new tokens", "wall_ms": wall_ms,
            "device_ms": total_ms, "device_busy_share": total_ms / wall_ms,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "calls": e.count} for e in top],
            "host_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "host_top": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host_top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from aqlm_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _, build_s = _build.library()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ptxas.txt"), "w") as f:  # registers, smem, spills
        for name in sorted(os.listdir(_build.BUILD_DIR)):
            if name.endswith(".log"):
                with open(os.path.join(_build.BUILD_DIR, name)) as log:
                    f.write(f"== {name}\n{log.read()}\n")
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s})
    print(smi, flush=True)

    failures = []
    gen = torch.Generator(device=dev).manual_seed(0)
    phase_s = {"build": build_s}
    t0 = time.perf_counter()
    with torch.inference_mode():
        reps = check_k1_k2(gen, dev, failures)
        reps.update(check_k3(gen, dev, failures))
        reps.update(check_int8(gen, dev, failures))
        reps.update(check_int4(gen, dev, failures))
        reps.update(check_int8_moe(gen, dev, failures))
        reps.update(check_int4_moe(gen, dev, failures))
        reps.update(check_onehot(gen, dev, failures))
    phase_s["checks"] = time.perf_counter() - t0
    if failures:
        print(f"chip_smoke: {len(failures)} kernel checks out of tolerance", file=sys.stderr)
        return 2

    for run in RUNS:
        t0 = time.perf_counter()
        ref = reference_check(dev, run)
        phase_s[f"reference_{run}"] = ref["seconds"] = time.perf_counter() - t0
        emit(ref)
        if not ref["ok"]:
            print(f"chip_smoke: {run} kernels disagree with the CPU reference", file=sys.stderr)
            return 3

    runs = {}
    for run in RUNS:
        t0 = time.perf_counter()
        runs[run] = engine_run(dev, run)
        phase_s[f"engine_{run}"] = runs[run]["seconds"] = time.perf_counter() - t0
        emit(runs[run])
        if not runs[run]["ok"]:
            print(f"chip_smoke: the {run} engine run failed its checks", file=sys.stderr)
            return 4

    emit({"phase": "seconds", **phase_s, "total": time.perf_counter() - T_START})
    kernels = []
    for name, info in _build.KERNELS.items():
        r = reps[name]
        by_run = {run: rec["launches"][name] for run, rec in runs.items()
                  if name in PATH_KERNELS[run]}
        kernels.append({"name": name, "route": "cuda", "source": info.source,
                        "replaces": info.replaces, "also_replaces": list(info.also_replaces),
                        "launches": sum(by_run.values()), "launches_by_run": by_run,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": {k: r[k] for k in r if k in (
                            "proj", "experts", "rows", "kv", "window", "B", "max_len")}})
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
