#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aqlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printed as JSON lines; any failure exits non-zero:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the time to build the CUDA kernels from csrc/;
2. checks: each kernel (K1 LUT-GEMV, K2 gather-prefill, K3 fused KV write +
   flash decode, the W8A16 int8 matmul, the W4A16 int4 matmul, the
   all-expert W8A16 and W4A16 MoE matmuls, B15, the dequant-matmul over
   untiled codes, and the calibration's B13 dequant and B14 codebook-gradient
   segment sum, also in the scanned PV student's forms: W^T with row scales
   in bf16 and f32, and the backward's scaled groups) against its plain
   PyTorch version on the card, at the shapes
   of the serving and calibration paths, K1's and B10's records with the
   launch their planning functions chose (K1: columns a block, code reads,
   tables, ring stages, splits, blocks; B10: GEMV or GEMM, rows a block,
   stages, splits, grid; the int8 and int4 kernels and their all-expert
   forms: the GEMV's blocks, staged runs and shared memory, or the GEMM's
   rows a block, stages, splits and grid; at T=1024 the last four also time
   ``torch.matmul`` on the weight widened to bf16 beforehand, an aside the
   port never calls) (K1 at every decode batch bucket of phase 4's
   ServeConfig, K2 at every prefill bucket, both also at
   Falcon-7B's fc1, the int8 kernel at both for Llama-2-7B's four
   projections and the lm_head, the int4 kernel at both for the four
   projections, each MoE kernel at both for Mixtral-8x7B's gate/up, shared
   x, and down, per-expert x, B15 at both for Falcon-7B's q, k, v, o and
   fc2, K3 at Llama-2-7B's 32 kv heads (B=4, and B=1 at offset 1999), at
   Mixtral-8x7B's 4 query heads over each of 8 and at Falcon-7B's 71 over
   one (each record with its split plan: the row kernel's keys a split,
   splits and shared memory, or the split-KV kernel's), the all-expert codes
   matmul at Mixtral-8x7B's gate/up and down (K1's MoE instance at the
   decode rows, K2's f32 instance over all experts in one launch at the
   prefill rows), the 1x16 GEMV and GEMM at Llama-2-7B's q, gate
   and down at g=8 and q at g=16, B13 at Llama-2-7B's q, gate and down in
   2x8 (precise: bit-identical; bf16 selection: one bf16 step), B14 at
   the groups of q and gate (within 1e-5 of each segment's sum of |data| of
   a float64 sum), and the activation backward of the lora phase: B10
   (``int8_matmul_transposed``) at its q, gate and down at 1024 rows and at
   q at rows 1, 8 and 200 (one bf16 step), B5 (``gather_dequant_wt``) at
   q, gate and down (bit-identical; beside it a ``fill_`` of W^T, the
   card's write ceiling), B6 (``flash_decode``, K3 without the
   row write) at K3's three shapes, int8 and bf16, lengths 1/512/513/2048,
   with and without a window of 256, and its unindexed form once (one bf16
   step, the cache unchanged), and B8 (``kv_write``) into a full-depth
   Llama-2-7B cache [32, 4, 32, 2048, 128], the one-array write of a bf16 cache
   and the four-array write of the int8 one (bit-identical; beside it the
   floor of one CUDA-graph kernel node, a one-element ``fill_``)), and B16
   (``gather_wraps``, the lane-gather wrap probe: bit-identical), with its
   time, the plain version's time, the least
   time the card could take (bound) and, where one PyTorch call computes
   the same function, its time (for a MoE kernel with per-expert x, where
   none does, the sum of one call per expert, as an aside);
3. reference: a 2-layer model at full Llama-2-7B width, in codes mode, in
   int8 mode (int8 lm_head) and in int4 mode (dense head), a 2-layer
   Mixtral-8x7B in int8 mode (int8 lm_head) and in int4 mode (dense head),
   a 2-layer Falcon-7B in codes mode (gated with a bf16 KV cache, the
   int8 one beside it; see ``reference_check``), a 2-layer Mixtral-8x7B in
   2x8 codes with stacked experts and a 2-layer Llama-2-7B in 1x16 codes
   (also through the unstacked llama.forward over 128 tokens, the flagship's
   own shape), kernels on the card against the plain versions on the CPU,
   prefill and decode logits;
4. engine: eight Engine.generate runs at full width (random weights from a
   seed, int8 KV cache), the first at full depth and the others cut to
   ENGINE_CUT_LAYERS layers (so the script stays inside its time limit), on
   6 prompts of 64-1500 tokens, 64
   new tokens each, greedy: Llama-2-7B in 2x8 codes, in int8 with the int8
   lm_head and in int4 with the dense head, then Mixtral-8x7B in int8 with
   the int8 lm_head and in int4 with the dense head, both loaded with
   donate_params, then Falcon-7B in 2x8 codes, then Mixtral-8x7B in 2x8
   codes with its experts stacked by the caller (stack_experts with donate,
   then donate_params), then Llama-2-7B in 1x16 codes (each engine is freed
   before the next is built). Launch counts are reset before and read after
   each run; each run must launch the kernels of its own path and none of
   the others' (B13 and B14 included), an int8 or int4 Mixtral run its MoE
   kernel 3 times per layer per forward, the codes Mixtral K1's MoE
   instance 3 times per layer per decode forward and K2's f32 instance 3
   times per layer per prefill forward (all experts in one launch), the
   Falcon run B15 5 times per K1/K2
   launch (q/k/v/o/fc2 against fc1), and the 1x16 run its GEMV 7 times per
   layer per decode forward and its GEMM a multiple of 7 x layers times;
   then ``int8_short``: Llama-2-7B in int8 (int8 lm_head) at max_len 512
   and ENGINE_CUT_LAYERS layers,
   where decode writes its rows with B8 and attends by the plain attention,
   4 prompts of 64-380 tokens, 64 new tokens, greedy, with decode_chunk 1
   and 8: identical tokens, B8 once per layer per decode forward, K3 and B6
   never,
   no synchronising call inside a chunk; then ``spec``: speculative
   decoding (``Engine(..., draft_params=, spec_k=4)``) on Llama-2-7B in 2x8
   codes at full width and depth, drawn well-scaled (``weight_scale=1.0``),
   max_len 512, 4 prompts of 16-200 ids, 32 new tokens: a self-draft greedy
   and sampled, the target's first 4 layers as the draft, and the plain
   Engine: each greedy spec answer within 3e-2 max|logit| of the target's
   own choice at every position (one teacher-forced forward), the
   self-draft's acceptance >= 0.9, K1/K2/K3 launches equal to
   ``spec_launch_formula``, no synchronising call inside a round, flash
   decode against the plain attention at 32 layers within 3e-2 max|logit|;
5. calibration: ``aqlm_tpu_torch.cli.quantize.main`` in-process on
   random:llama2_7b:2 (two layers at full width) in 2x8 g8 on random ids
   (16 x 512 tokens, 2 epochs of 10 AMSGrad steps, a beam sweep after each,
   one block-finetune epoch), outside inference mode, saved to
   build/calib_checkpoint (deleted once served): every projection's final
   MSE below its k-means-init MSE, finite out losses, B13 and B14 launched exactly as the config's
   formula says and no serving kernel; seconds by part and peak memory;
   then PV-tuning (``pv``): ``aqlm_tpu_torch.cli.finetune.main`` in-process,
   the calibrated checkpoint as the student of the dense seed-0 model it was
   quantized from, 8 steps of 2 x 2 x 512 random ids (a V step every 2,
   the training state saved every 4) into build/pv_checkpoint (deleted at the
   end of the phase), then 4 steps with ``--st_window 1 --offload_teacher``:
   finite KL; the tuned student's KL on a held-out 2 x 512 batch below the
   calibrated one's; every V step within ceil(1e-2 x groups) changed groups
   and not farther from its buffer; B13 and B14 exactly as
   ``pv_launch_formula`` says, no other kernel; the second run's KL within
   1e-3 of the first's; the saved codes the final state's; one gradient pass
   at 1 x 128 ids on the card within 1e-2 (loss) and 3e-2 of max|grad| of
   the CPU's; seconds per step (gradient pass, update, V step), peak memory
   and B13's and B14's share of the steps; then ``pv_scan``: the same CLI
   with ``--scan_blocks`` (the scanned student, its projections B13 forward,
   B13 + B14 backward) for 4 steps, then with ``--scan_blocks --st_window 1
   --offload_teacher``: each step's KL within 1e-3 of the same step of the
   two runs above, the groups whose codes differ recorded, B13/B14 exactly as
   ``pv_scan_launch_formula`` says, one scanned gradient pass on the card
   within 1e-2 (loss) and 3e-2 of max|grad| of the CPU's with the kernels'
   plain versions; then ``pv_scan_depth``: a random 2x8 Llama-2-7B in bf16,
   one gradient pass of the scanned student at 8 and 32 layers and of the
   unrolled one at 8 (three each: seconds, peak memory, launches against
   ``depth_launch_formula``, finite values), and at 8 layers in f32 scanned
   against unrolled within 1e-2 (loss) and 3e-2 of max|grad| (window and
   codebook gradients); then ``convert``: ``cli.convert --to requant
   --scheme 1x8`` of the calibrated checkpoint (every projection below its
   k-means init) and ``--to 2x8`` / ``--to 2x7`` of a 2-layer 1x16
   checkpoint, each output served as in phase 6, and README's speculative
   recipe (``cli.generate`` of the calibrated checkpoint with its 1x8
   requant as ``--draft_model``: 32 new tokens, K1/K2/K3 only);
6. serve the calibrated checkpoint: loaded, transcoded to codes mode and
   served by Engine.generate (4 prompts, 16 new tokens): K1, K2 and K3
   launch, B13 and B14 do not; its prefill logits within 3e-2 max|logit|
   of the same checkpoint in reference mode on the card (B13);
7. LoRA training (``pv.lora.make_lora_step``, torch.optim.Adam), outside
   inference mode: first a 2-layer full-width step on the card against the
   same step on the CPU (plain versions), in 2x8 codes and in int8 (loss and
   every adapter gradient, and the card's launches); then Llama-2-7B at full
   width and depth, 2x8 codes then int8 with a dense bf16 head (each freed
   before the next), adapters (r 8, alpha 16) on q/k/v/o of every layer, 6
   steps on one batch of 2 x 512 ids: finite losses, the last below the
   first, every adapter moved, every frozen tensor bit-unchanged, and per
   step 7 x 32 forward launches (K2 or the int8 kernel) and 7 x 32 - 3
   backward launches (B5 or B10), nothing else; seconds per step, trained
   tokens/s, peak memory and a profiled step's device time by kernel;
8. the entry points a user calls, on one canonical Llama-2-7B checkpoint
   (2x8 g8, full width, ENTRY_LAYERS layers, random weights from a seed, bf16 embedding,
   norms and head) written by the port's ``save_quantized_model`` under
   build/ with its ``cli.convert --to int8`` and 2-layer cuts (deleted at
   the end): ``unstacked_decode`` (``llama.forward`` in codes mode, batch 4,
   a 64-token prefill into ``llama.init_kv_cache`` and 8 cached steps: K2
   and K1 by their unindexed forms exactly 7 x layers a forward, nothing
   else;
   the last logits against ``forward_stacked``), ``evaluate``
   (``cli.evaluate.main`` on 4 random windows of 4096 ids in codes, int8
   (the materialized checkpoint), int4 (transcoded at load) and reference
   mode: finite perplexities, codes within 1e-2 of reference in ln PPL, each
   mode's kernel launched 4 x layers x 7 times by its unindexed form, and at 2
   layers the card within 1e-2 of the CPU in ln PPL), and ``cli_serve``
   (``cli.serve`` on the int8 checkpoint, 8 concurrent /v1/completions
   requests, 2 streamed and 2 with logprobs: tokens identical to an Engine
   replaying the server loop's calls; requests/s, latency, time to first
   token; then ``cli.generate --benchmark --mode codes``; then the same
   server with ``--draft_model`` (the canonical checkpoint in codes mode)
   answering 4 of the requests, held to a replaying speculative Engine, and
   ``cli.generate --draft_model ... --benchmark``);
9. the seconds of each phase, the kernel list (launches over the engine,
   speculative, calibration, PV-tuning, serving, training and entry-point
   runs, and for K1, K2, int8 and int4 the launches by wrapper form), then {"ok": true,
   "device": {...}} as the last line.

Writes chiprun_out/chip_smoke.json with every record and
chiprun_out/ptxas.txt with the kernels' register and shared-memory report.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
RECORDS = []
T_START = time.perf_counter()


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def starting(phase: str) -> None:
    """A phase's start on stderr, with the seconds since the script began."""
    print(f"chip_smoke: {phase} at {time.perf_counter() - T_START:.1f} s", file=sys.stderr,
          flush=True)


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


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def k1_plan_record(p) -> dict:
    """K1's launch as ``lut_gemv.plan`` chose it: columns a block, the lane's
    code reads, tables of a chunk, code-ring stages, splits, grid."""
    return {"cols": p.cols, "rows_computed": p.bp, "colvec": p.colvec, "tables": p.tables,
            "stages": p.stages, "splits": p.splits, "gb_per_split": p.gb_per_split,
            "blocks": p.grid[0] * p.grid[1] * p.grid[2], "smem": p.smem}


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
                                                 pm, torch.bfloat16, 8, proj_cols=math.gcd(*sizes))
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
                if kernel == "lut_gemv":
                    rec["plan"] = k1_plan_record(lg.plan(rows, 2, out_f, in_f // 8, tn, P, 1,
                                                         _sm_count(), math.gcd(*sizes)))
                emit(rec)
                if not cmp["ok"]:
                    failures.append(rec)
                if name == "qkv" and rows == rep_rows[kernel]:
                    reps[kernel] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


def plan_record(p) -> dict:
    """The int8 or int4 kernel's launch as its ``plan`` chose it."""
    return dataclasses.asdict(p)


def bf16_matmul_aside(x, w_bf16, iters: int = 5) -> dict:
    """An aside at T=1024: ``torch.matmul`` of x and the weight widened to
    bf16 beforehand (what cuBLAS reaches for the same product; it needs the
    bf16 weight in memory, and the port never calls it). w_bf16 [OUT, IN]
    or [E, OUT, IN]; x [T, IN] or [E, T, IN]."""
    run = lambda i=0: torch.matmul(x, w_bf16.transpose(-1, -2))
    return {"bf16_matmul": "torch.matmul on the pre-widened bf16 weight (an aside)",
            "bf16_matmul_ms": time_ms(run, iters)}


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
                   "library_error": library_error, "host_ms": host_ms(run),
                   "plan": plan_record(im.plan(rows, out_f, in_f, ld, 1, _sm_count()))}
            if rows == 1024:
                rec.update(bf16_matmul_aside(x[0], w8[0, :, :in_f].to(torch.bfloat16)))
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
                   "library_error": rec_error, "host_ms": host_ms(run),
                   "plan": plan_record(i4.plan(rows, out_f, in_f, w4.shape[-1], 1, _sm_count()))}
            if rows == 1024:
                rec.update(bf16_matmul_aside(
                    x[0], i4.dequantize_int4(w4[0], gs[0])[:, :in_f].to(torch.bfloat16)))
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
                   "library_error": library_error, "host_ms": host_ms(run),
                   "plan": plan_record(im.plan(rows, out_f, in_f, w8.shape[-1], E, _sm_count()))}
            if rows == 1024:
                rec.update(bf16_matmul_aside(x[0], w8[0, ..., :in_f].to(torch.bfloat16), 2))
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
                   "library_error": rec_error, "host_ms": host_ms(run),
                   "plan": plan_record(i4.plan(rows, out_f, in_f, w4.shape[-1], E, _sm_count()))}
            if rows == 1024:
                w_bf16 = torch.stack([i4.dequantize_int4(w4[0, e], gs[0, e])[:, :in_f]
                                      for e in range(E)]).to(torch.bfloat16)
                rec.update(bf16_matmul_aside(x[0], w_bf16, 2))
                del w_bf16
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
    """B15 at Falcon-7B's five projections, every main-path row count, two
    bf16 steps from its plain version; each launch's plan, and at T=1024 a
    bf16 ``torch.matmul`` aside on the pre-dequantized weight."""
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
            ms = time_ms(run, 50 if rows <= 256 else 10)
            plain_ms = time_ms(plain, 3)
            b_ms, b_by = bound(K * ig * out_f + rows * in_f * 2 + rows * out_f * 2 + K * 256 * 8 * 2
                               + out_f * 4, 2.0 * rows * out_f * in_f)
            aside = {}
            if rows == 1024:
                w = k15.dequant_t(codes[0], cb[0]).to(torch.bfloat16).t().contiguous()
                aside = bf16_matmul_aside(x[0], w)
                del w
            # no one PyTorch call computes a codes dequant-matmul: no library column
            rec = {"phase": "check", "kernel": "onehot_matmul", "proj": name, "rows": rows,
                   "out_features": out_f, "in_features": in_f, **cmp, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, **aside,
                   "library": "none", "library_ms": None, "host_ms": host_ms(run),
                   "plan": dataclasses.asdict(k15.onehot_plan(rows, out_f, ig, K, _sm_count()))}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "q" and rows == 4:
                reps["onehot_matmul"] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


def check_moe_codes(gen, dev, failures):
    """The all-expert codes matmul at Mixtral-8x7B's gate/up (shared x) and
    down (per-expert x): K1's MoE instance at the decode rows, one bf16 step
    from its plain version (the f32-weight function aqlm_tpu computes); K2's
    f32 instance, all experts in one launch, at the prefill rows, one bf16 step from
    K2's plain version with an f32 output (the weight rounded to bf16, as K2
    rounds it), and also held against the f32-weight function within the
    weight's rounding bound 2^-8 * (|x| @ |W|^T) * scale + 1e-3 max|plain|
    (two bf16 steps would not hold there: K2's rounded weight moves a few
    elements near zero further)."""
    from aqlm_tpu_torch.ops import gather_prefill as gp
    from aqlm_tpu_torch.ops import lut_gemv as lg

    reps = {}
    L = 2  # two stacked layers cycled: one launch reads 117 MB, past the 50 MB L2
    decode, prefill = main_path_rows(engine_serve_config("mixtral_codes"))
    for name, E, out_f, in_f, per_expert in MOE_PROJS:
        tn = lg.lut_tile_n(out_f)
        nt, kig = out_f // tn, in_f // 8 * 2
        codes = torch.randint(0, 256, (L, E, nt, kig, tn), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((L, E, 2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand((L, E, out_f), generator=gen, device=dev) + 0.5
        for rows in decode + prefill:
            shape = (L, E, rows, in_f) if per_expert else (L, rows, in_f)
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            kernel = "lut_moe_gemv" if rows <= lg.LUT_GEMV_MAX_BATCH else "moe_gather_prefill"
            launch = lg.moe_launch if kernel == "lut_moe_gemv" else lg.moe_prefill_launch
            run = lambda i=0: launch(x[i % L], codes[i % L], cb[i % L], scales[i % L], 8)
            got = run(0)
            want = lg.moe_plain(x[0], codes[0], cb[0], scales[0])
            route = {}
            if kernel == "lut_moe_gemv":
                plain = lambda i=0: lg.moe_plain(x[0], codes[0], cb[0], scales[0])
                cmp = compare(got, want)
            else:
                xs = [x[0][e] if per_expert else x[0] for e in range(E)]
                plain = lambda i=0: torch.stack([gp.plain(xs[e], codes[0, e], cb[0, e][None],
                                                          scales[0, e], None, torch.float32)
                                                 for e in range(E)])
                cmp = compare(got, plain(0))
                err = (got - want).abs()
                wbound = torch.stack([
                    xs[e].float().abs() @ lg.dequant_tiled_t(codes[0, e], cb[0, e][None]).to(
                        torch.bfloat16).float().abs() * scales[0, e] for e in range(E)]) * 2 ** -8
                within = bool((err <= wbound + 1e-3 * want.abs().max()).all())
                route = {"route_vs_f32_weights": {
                    "max_abs_err": float(err.max()),
                    "within_two_steps": compare(got, want, steps=2)["ok"],
                    "within_weight_bound": within,
                    "tol": "2^-8 * (|x| @ |W|^T) * scale + 1e-3*max|plain|"}}
                cmp = {**cmp, "ok": cmp["ok"] and within}
                del err, wbound
            del got, want
            ms = time_ms(run, 20 if rows <= 8 else 3)
            plain_ms = time_ms(plain, 2)
            b_ms, b_by = bound(E * nt * kig * tn + x[0].numel() * 2 + E * rows * out_f * 4
                               + E * 2 * 256 * 8 * 2 + E * out_f * 4, 2.0 * E * rows * out_f * in_f)
            # no one PyTorch call dequantizes codes: no library column
            rec = {"phase": "check", "kernel": kernel, "proj": name, "experts": E, "rows": rows,
                   "out_features": out_f, "in_features": in_f,
                   "x": "per expert" if per_expert else "shared", **cmp, **route, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library": "none",
                   "library_ms": None, "host_ms": host_ms(run, 20)}
            if kernel == "lut_moe_gemv":
                rec["plan"] = k1_plan_record(lg.plan(rows, 2, out_f, in_f // 8, tn, 1, E,
                                                     _sm_count()))
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "gate_up" and rows in (4, max(prefill)):
                reps[kernel] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


# (name, out_features, in_features, group): Llama-2-7B's 1x16 launches of a
# block at g=8 (q/k/v/o share q's shape, up gate's), and one g=16 shape
GATHER16_PROJS = [("q", 4096, 4096, 8), ("gate", 11008, 4096, 8), ("down", 4096, 11008, 8),
                  ("q_g16", 4096, 4096, 16)]


def gather_ceiling() -> dict:
    """The card's L2 gather ceiling (experiments/torch_gather_ceiling.py's
    micro-kernel, built here): random 16-byte rows of a 1 MB table and
    32-byte rows of a 2 MB one (lane pairs), codes streaming from device
    memory; G rows a second by row width."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments",
                        "torch_gather_ceiling.py")
    spec = importlib.util.spec_from_file_location("torch_gather_ceiling", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    recs = probe.measure(probe.CEILING_CASES, n_codes=64 << 20, repeats=3)
    emit({"phase": "check", "kernel": "gather_ceiling", "records": recs})
    return {r["row_bytes"] // 2: r["g_rows_per_s"] for r in recs}  # by group: 8 -> 16 B rows


def check_gather16(gen, dev, failures):
    """The 1x16 GEMV (decode rows) and GEMM (prefill rows) against their
    plain version, one bf16 step; with a bias (added after, in bf16: a
    second rounding) at one row count of each form, two steps. Beside the
    bound, the L2 gather traffic (each code pulls one 2g-byte codebook row,
    once per launch in both forms: the GEMM's pre-pass gathers each weight
    once) and the card's gather ceiling; each launch's plan, and the GEMM's
    transient W (its planned bytes and the peak the launch adds); at T=1024 a
    bf16 ``torch.matmul`` aside."""
    from aqlm_tpu_torch.ops import gather16 as g16

    reps = {}
    ceiling = gather_ceiling()
    decode, prefill = main_path_rows(engine_serve_config("codes_1x16"))
    for name, out_f, in_f, grp in GATHER16_PROJS:
        ig = in_f // grp
        codes = torch.randint(-32768, 32768, (N_LAYERS_TIMED, out_f, ig), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int16)
        cb = (torch.randn((N_LAYERS_TIMED, 65536 * grp // 128, 128), generator=gen, device=dev)
              / 4).to(torch.bfloat16)
        scales = torch.rand((N_LAYERS_TIMED, out_f), generator=gen, device=dev) + 0.5
        bias = torch.randn(out_f, generator=gen, device=dev).to(torch.bfloat16)
        for rows in decode + prefill:
            x = torch.randn((N_LAYERS_TIMED, rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            kernel = "gather16_gemv" if rows <= g16.GATHER16_GEMV_MAX_BATCH else "gather16_gemm"
            launch = g16.gemv_launch if kernel == "gather16_gemv" else g16.gemm_launch
            run = lambda i=0: launch(x[i % N_LAYERS_TIMED], codes[i % N_LAYERS_TIMED],
                                     cb[i % N_LAYERS_TIMED], scales[i % N_LAYERS_TIMED], grp)
            plain = lambda i=0: g16.plain(x[0], codes[0], cb[0], scales[0], grp)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = run(0)
            torch.cuda.synchronize()
            peak_extra = torch.cuda.max_memory_allocated() - base
            cmp = compare(got, plain(0))
            del got
            biased = {}
            if rows in (4, 64):
                b_cmp = compare(g16.gather_matmul_16(x[0], codes[0], cb[0], scales[0], bias, group=grp),
                                plain(0) + bias, steps=2)
                biased = {"with_bias": b_cmp}
                cmp["ok"] = cmp["ok"] and b_cmp["ok"]
            ms = time_ms(run, 50 if rows <= 256 else 10)
            plain_ms = time_ms(plain, 3)
            b_ms, b_by = bound(out_f * ig * 2 + 65536 * grp * 2 + rows * in_f * 2 + rows * out_f * 2
                               + out_f * 4, 2.0 * rows * out_f * in_f)
            p = g16.plan(rows, out_f, ig, grp, _sm_count())
            l2 = out_f * ig * grp * 2 * p.gathers_per_weight
            rows_per_s = out_f * ig * p.gathers_per_weight / (ms * 1e-3) / 1e9
            aside = {}
            if rows == 1024:
                w = g16._weight(codes[0], cb[0], grp)
                aside = bf16_matmul_aside(x[0], w)
                del w
            # no one PyTorch call computes a codebook-gather matmul: no library column
            rec = {"phase": "check", "kernel": kernel, "proj": name, "rows": rows, "group": grp,
                   "out_features": out_f, "in_features": in_f, **cmp, **biased, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "l2_gather_bytes": l2, "l2_gather_tb_s": l2 / (ms * 1e-3) / 1e12,
                   "gathers_per_weight": p.gathers_per_weight, "l2_gather_g_rows_per_s": rows_per_s,
                   "l2_ceiling_g_rows_per_s": ceiling[grp],
                   "share_of_ceiling": rows_per_s / ceiling[grp], **aside,
                   "scratch_bytes": p.scratch_bytes, "peak_extra_bytes": peak_extra,
                   "library": "none", "library_ms": None, "host_ms": host_ms(run),
                   "plan": dataclasses.asdict(p)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if (name, rows) in (("q", 4), ("gate", max(prefill))):
                reps[kernel] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


# (name, out_features, in_features): Llama-2-7B's projections as calibration
# dequantizes them (2x8 g8; k/v/o share q's shape, up gate's)
CALIB_PROJS = [("q", 4096, 4096), ("gate", 11008, 4096), ("down", 4096, 11008)]
F32_FLOP_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (B13's adds, B14's)
N_CALIB_COPIES = 4  # codes copies cycled while timing B13


def _f32_bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def check_calib(gen, dev, failures):
    """B13 (the calibration dequant) at q, gate and down, unit scales, as the
    differentiable dequant calls it: precise bit-identical to its plain
    version, bf16-selecting (precise=False) within one bf16 step; and precise
    with per-row scales (as ``dequantize_onehot`` calls it), bit-identical.
    B14 (the codebook gradient) at the groups of q and gate, K 2, S 256, g 8,
    both modes: each segment within 1e-5 of its sum of |data| of a float64
    plain sum (of the bf16-rounded data when not precise); whether a second
    run is bitwise the first is recorded. Library calls: B13's function is
    ``embedding_bag(mode="sum")`` over codes offset by k*S into the
    flattened codebooks (the reference's own dequant); B14's one
    ``index_add_`` over the flat index k*S + code with the data expanded per
    codebook (indices and expansion made before the timed call)."""
    import torch.nn.functional as F

    from aqlm_tpu_torch.ops import kernels as kn

    reps = {}
    K, S, g = 2, 256, 8
    for name, out_f, in_f in CALIB_PROJS:
        ig = in_f // g
        codes = torch.randint(0, S, (N_CALIB_COPIES, out_f, ig, K), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = torch.randn((K, S, g), generator=gen, device=dev) / 4
        row_scales = torch.rand(out_f, generator=gen, device=dev) + 0.5
        for precise, scaled in ((True, False), (False, False), (True, True)):
            sc = row_scales if scaled else None
            got = kn.dequant_launch(codes[0], cb, sc, precise=precise)
            want = kn.dequant_plain(codes[0], cb, sc, precise=precise)
            if precise:
                err = float((got - want).abs().max())
                cmp = {"max_abs_err": err, "bit_identical": bool(torch.equal(got, want)),
                       "tol": "bit-identical", "ok": bool(torch.equal(got, want))}
            else:
                cmp = compare(got, want)
            del got, want
            run = lambda i=0: kn.dequant_launch(codes[i % N_CALIB_COPIES], cb, sc, precise=precise)
            plain = lambda i=0: kn.dequant_plain(codes[0], cb, sc, precise=precise)
            ms = time_ms(run, 20)
            plain_ms = time_ms(plain, 3)
            library_ms = None
            if precise and not scaled:
                idx = codes[0].reshape(-1, K).long() + torch.arange(K, device=dev) * S
                table = cb.reshape(K * S, g)
                library = lambda i=0: F.embedding_bag(idx, table, mode="sum")
                cmp["library_max_abs_err"] = float(
                    (library().reshape(out_f, in_f) - kn.dequant_plain(codes[0], cb)).abs().max())
                library_ms = time_ms(library, 20)
                del idx
            G = out_f * ig
            b_ms, b_by = _f32_bound(  # codes, codebooks, W (and the scales, their products)
                G * K + K * S * g * 4 + out_f * in_f * 4 + (out_f * 4 if scaled else 0),
                G * g * K + (out_f * in_f if scaled else 0))
            rec = {"phase": "check", "kernel": "dequantize_onehot", "proj": name,
                   "out_features": out_f, "in_features": in_f, "K": K, "S": S, "precise": precise,
                   "scales": scaled, **cmp, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by,
                   "library": None if scaled else "F.embedding_bag(mode='sum')",
                   "library_ms": library_ms, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "gate" and precise and not scaled:
                reps["dequantize_onehot"] = rec
            torch.cuda.empty_cache()
        if name != "down":  # B14 at the groups of q and of gate
            flat = codes[0].reshape(-1, K)
            G = flat.shape[0]
            data = torch.randn((G, g), generator=gen, device=dev)
            for precise in (True, False):
                got = kn.cb_grad_launch(flat, data, S, precise=precise)
                d64 = (data if precise else data.to(torch.bfloat16).float()).double()
                want = torch.zeros((K, S, g), dtype=torch.float64, device=dev)
                mass = torch.zeros((K, S, g), dtype=torch.float64, device=dev)
                for k in range(K):
                    want[k].index_add_(0, flat[:, k].long(), d64)
                    mass[k].index_add_(0, flat[:, k].long(), d64.abs())
                err = (got.double() - want).abs()
                ok = bool(torch.isfinite(got).all()) and bool((err <= 1e-5 * mass).all())
                rerun = bool(torch.equal(got, kn.cb_grad_launch(flat, data, S, precise=precise)))
                cmp = {"max_abs_err": float(err.max()), "rerun_bitwise": rerun,
                       "max_err_over_mass": float((err / mass.clamp(min=1e-30)).max()),
                       "tol": "1e-5 * segment sum of |data| (float64 plain sum)", "ok": ok}
                del got, want, mass, d64, err
                run = lambda i=0: kn.cb_grad_launch(flat, data, S, precise=precise)
                plain = lambda i=0: kn.cb_grad_plain(flat, data, S, precise=precise)
                ms = time_ms(run, 20)
                plain_ms = time_ms(plain, 3)
                library_ms = None
                if precise:
                    lidx = (flat.long() + torch.arange(K, device=dev) * S).reshape(-1)
                    ldata = data[:, None, :].expand(G, K, g).reshape(G * K, g).contiguous()
                    lout = torch.zeros((K * S, g), device=dev)
                    library = lambda i=0: lout.index_add_(0, lidx, ldata)
                    library_ms = time_ms(library, 20)
                    del lidx, ldata, lout
                b_ms, b_by = _f32_bound(G * g * 4 + G * K + K * S * g * 4, G * g * K)
                rec = {"phase": "check", "kernel": "cb_grad_segment", "proj": name, "groups": G,
                       "K": K, "S": S, "precise": precise, **cmp, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library": "Tensor.index_add_", "library_ms": library_ms,
                       "host_ms": host_ms(run)}
                emit(rec)
                if not ok:
                    failures.append(rec)
                if name == "gate" and precise:
                    reps["cb_grad_segment"] = rec
            del data, flat
        del codes, cb
        torch.cuda.empty_cache()
    return reps


def check_manual_proj(gen, dev, failures):
    """B13 and B14 in the forms the scanned PV student's manual projections
    launch them (``pv.straight_through._make_manual_st_proj``), at
    Llama-2-7B's q, gate and down in 2x8: B13 as ``dequantize_onehot`` to
    W^T [IN, OUT] with the [OUT] row scales and the codebook entries rounded
    to bf16 first (precise=False, as JAX's kernel dequant), in bf16 (the
    forward of a bf16 student) and in f32 (the backward, and an f32
    student's forward): bit-identical to its plain version on the same
    inputs (the f32 sum is the plain one's; bf16 is its rounding); B14 on
    the backward's scaled groups (dL/dW's groups times each row's scale,
    f32): each segment within 1e-5 of its sum of |data| of a float64 sum.
    Library calls as ``check_calib``'s: ``F.embedding_bag(mode="sum")`` over
    the bf16-rounded books (then the scales and the cast), one
    ``index_add_``."""
    import torch.nn.functional as F

    from aqlm_tpu_torch.ops import kernels as kn

    K, S, g = 2, 256, 8
    for name, out_f, in_f in CALIB_PROJS:
        ig = in_f // g
        codes = torch.randint(0, S, (N_CALIB_COPIES, out_f, ig, K), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        cb = torch.randn((K, S, g), generator=gen, device=dev) / 4
        scales = torch.rand(out_f, generator=gen, device=dev) + 0.5
        codes_t = codes.permute(0, 3, 2, 1)  # [copies, K, IG, OUT] views, as the projection passes
        for dtype in (torch.bfloat16, torch.float32):
            run = lambda i=0, d=dtype: kn.dequantize_onehot(codes_t[i % N_CALIB_COPIES], cb, scales,
                                                           group=g, dtype=d)
            got = run()
            want = kn.dequant_plain(codes[0], cb, scales, precise=False).to(dtype).t()
            same = bool(torch.equal(got, want))
            cmp = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                   "bit_identical": same, "tol": "bit-identical", "ok": same}
            del got, want
            ms = time_ms(run, 20)
            plain_ms = time_ms(lambda i=0, d=dtype: kn.dequant_plain(
                codes[0], cb, scales, precise=False).to(d).t(), 3)
            idx = codes[0].reshape(-1, K).long() + torch.arange(K, device=dev) * S
            table = cb.to(torch.bfloat16).float().reshape(K * S, g)
            library = lambda i=0, d=dtype: (F.embedding_bag(idx, table, mode="sum").reshape(
                out_f, in_f) * scales[:, None]).to(d).t()
            library_ms = time_ms(library, 20)
            del idx, table
            G = out_f * ig
            b_ms, b_by = _f32_bound(  # codes, books, scales read; W^T written in dtype
                G * K + K * S * g * 4 + out_f * 4 + out_f * in_f * (2 if dtype == torch.bfloat16
                                                                    else 4),
                G * g * K + out_f * in_f)
            rec = {"phase": "check", "kernel": "dequantize_onehot", "form": "manual_wt",
                   "proj": name, "out_features": out_f, "in_features": in_f, "K": K, "S": S,
                   "precise": False, "scales": True, "dtype": str(dtype).split(".")[-1], **cmp,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "F.embedding_bag(mode='sum') * scales, cast",
                   "library_ms": library_ms, "host_ms": host_ms(run)}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            torch.cuda.empty_cache()
        # B14 on the backward's data: dL/dW's groups times their row's scale
        flat = codes[0].reshape(-1, K)
        G = flat.shape[0]
        gw = torch.randn((out_f, in_f), generator=gen, device=dev) * 1e-3
        data = (gw.reshape(out_f, ig, g) * scales[:, None, None]).reshape(-1, g)
        del gw
        got = kn.cb_grad_segment(flat, data, S)
        want = torch.zeros((K, S, g), dtype=torch.float64, device=dev)
        mass = torch.zeros((K, S, g), dtype=torch.float64, device=dev)
        for k in range(K):
            want[k].index_add_(0, flat[:, k].long(), data.double())
            mass[k].index_add_(0, flat[:, k].long(), data.double().abs())
        err = (got.double() - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= 1e-5 * mass).all())
        cmp = {"max_abs_err": float(err.max()),
               "max_err_over_mass": float((err / mass.clamp(min=1e-30)).max()),
               "tol": "1e-5 * segment sum of |data| (float64 plain sum)", "ok": ok}
        del got, want, mass, err
        run = lambda i=0: kn.cb_grad_segment(flat, data, S)
        ms = time_ms(run, 20)
        plain_ms = time_ms(lambda i=0: kn.cb_grad_plain(flat, data, S), 3)
        lidx = (flat.long() + torch.arange(K, device=dev) * S).reshape(-1)
        ldata = data[:, None, :].expand(G, K, g).reshape(G * K, g).contiguous()
        lout = torch.zeros((K * S, g), device=dev)
        library_ms = time_ms(lambda i=0: lout.index_add_(0, lidx, ldata), 20)
        del lidx, ldata, lout
        b_ms, b_by = _f32_bound(G * g * 4 + G * K + K * S * g * 4, G * g * K)
        rec = {"phase": "check", "kernel": "cb_grad_segment", "form": "manual_bwd", "proj": name,
               "groups": G, "K": K, "S": S, "precise": True, **cmp, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library": "Tensor.index_add_", "library_ms": library_ms, "host_ms": host_ms(run)}
        emit(rec)
        if not ok:
            failures.append(rec)
        del codes, codes_t, cb, scales, data, flat
        torch.cuda.empty_cache()


# (name, out_features, in_features): the projections of a Llama-2-7B block
# whose activation backward runs B5 (codes) or B10 (int8) in the lora phase
BWD_PROJS = [("q", 4096, 4096), ("gate", 11008, 4096), ("down", 4096, 11008)]
BWD_ROWS = 1024  # B * T of the lora phase's batch (2 x 512)


def check_b10(gen, dev, failures):
    """B10 (``int8_matmul_transposed``) at the lora phase's three OUT -> IN
    pairs at 1024 rows, and at rows 1, 8 and 200 at q, bf16 gradients,
    within one bf16 step of its plain version. Library: one
    ``torch._weight_int8pack_mm`` over the bf16(g * scale) operand and a w8^T
    [IN_pad, OUT] made once outside the timing, unit scales."""
    from aqlm_tpu_torch.ops import int8_matmul as im

    reps = {}
    for name, out_f, in_f in BWD_PROJS:
        ld = im.pad_in_features(in_f)
        w8 = torch.randint(-127, 128, (N_LAYERS_TIMED, out_f, ld), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        w8[..., in_f:] = 0
        scale = torch.rand((N_LAYERS_TIMED, out_f), generator=gen, device=dev) / (127 * in_f ** 0.5)
        w_lib = w8[0].t().contiguous()  # yardstick only
        ones = torch.ones(ld, dtype=torch.bfloat16, device=dev)
        for rows in ([1, 8, 200, BWD_ROWS] if name == "q" else [BWD_ROWS]):
            g = torch.randn((N_LAYERS_TIMED, rows, out_f), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i=0: im.launch_t(g[i % N_LAYERS_TIMED], w8[i % N_LAYERS_TIMED],
                                          scale[i % N_LAYERS_TIMED])
            plain = lambda i=0: im.plain_t(g[0], w8[0], scale[0])
            cmp = compare(run(0), plain(0))
            ms = time_ms(run, 20)
            plain_ms = time_ms(plain, 3)
            b_ms, b_by = bound(out_f * ld + rows * out_f * 2 + out_f * 4 + rows * ld * 2,
                               2.0 * rows * out_f * ld)
            library_ms = library_error = None
            try:
                gs = im.scaled_grad(g[0], scale[0])
                library = lambda i=0: torch._weight_int8pack_mm(gs, w_lib, ones)
                library_ms = time_ms(library, 10)
            except Exception as exc:  # the yardstick only: recorded, never on the port's path
                library_error = str(exc).strip().splitlines()[0][:200]
            pt = im.plan_t(rows, out_f, ld, _sm_count())
            rec = {"phase": "check", "kernel": "int8_matmul_transposed", "proj": name,
                   "rows": rows, "out_features": out_f, "in_features": ld, "true_in": in_f,
                   **cmp, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library": "torch._weight_int8pack_mm", "library_ms": library_ms,
                   "library_error": library_error, "host_ms": host_ms(run),
                   "plan": {"path": pt.path, "tile": pt.tile, "stages": pt.stages,
                            "splits": pt.splits, "per_split": pt.per_split,
                            "blocks": pt.grid[0] * pt.grid[1] * pt.grid[2], "smem": pt.smem}}
            emit(rec)
            if not cmp["ok"]:
                failures.append(rec)
            if name == "gate":
                reps["int8_matmul_transposed"] = rec
        del w8, scale, w_lib
        torch.cuda.empty_cache()
    return reps


def check_b5(gen, dev, failures):
    """B5 (``gather_dequant_wt``, bf16 W^T) at q, gate and down in 2x8,
    bit-identical to its plain version. No one PyTorch call computes it; the
    yardstick is the card's write ceiling as PyTorch reaches it, one
    ``fill_`` of W^T's bytes (``write_ceiling_ms``; ``share_of_ceiling`` is
    its time over B5's)."""
    from aqlm_tpu_torch.ops import gather_prefill as gp
    from aqlm_tpu_torch.ops import lut_gemv as lg

    reps = {}
    for name, out_f, in_f in BWD_PROJS:
        tn = lg.lut_tile_n(out_f)
        codes = torch.randint(0, 256, (N_LAYERS_TIMED, out_f // tn, in_f // 8 * 2, tn),
                              generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
        cb = (torch.randn((2, 256, 8), generator=gen, device=dev) / 4).to(torch.bfloat16)
        scales = torch.rand(out_f, generator=gen, device=dev) + 0.5
        got = gp.dequant_wt_launch(codes[0], cb, scales)
        want = gp.dequant_wt_plain(codes[0], cb, scales)
        same = bool(torch.equal(got, want))
        cmp = {"max_abs_err": float((got.float() - want.float()).abs().max()),
               "bit_identical": same, "tol": "bit-identical", "ok": same}
        del got, want
        run = lambda i=0: gp.dequant_wt_launch(codes[i % N_LAYERS_TIMED], cb, scales)
        plain = lambda i=0: gp.dequant_wt_plain(codes[0], cb, scales)
        ms = time_ms(run, 20)
        plain_ms = time_ms(plain, 3)
        b_ms, b_by = _f32_bound(in_f * out_f * 2 + out_f * in_f // 4 + 2 * 256 * 8 * 2 + out_f * 4,
                                2.0 * out_f * in_f)  # an add and the scale product a weight
        wt = torch.empty((in_f, out_f), dtype=torch.bfloat16, device=dev)
        ceiling_ms = time_ms(lambda i=0: wt.fill_(1.0), 20)
        del wt
        p = gp.dequant_wt_plan(out_f, in_f // 8, torch.bfloat16, _sm_count())
        rec = {"phase": "check", "kernel": "gather_dequant_wt", "proj": name,
               "out_features": out_f, "in_features": in_f, "tn": tn, "K": 2, **cmp, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "write_ceiling_ms": ceiling_ms, "share_of_ceiling": ceiling_ms / ms,
               "host_ms": host_ms(run), "plan": dataclasses.asdict(p)}
        emit(rec)
        if not cmp["ok"]:
            failures.append(rec)
        if name == "gate":
            reps["gather_dequant_wt"] = rec
        del codes, cb, scales
        torch.cuda.empty_cache()
    return reps


def _sdpa_ms(q_hm, k_c, v_c, lengths, window, S, L, dev):
    """Yardstick only: one SDPA call over a bf16 cache [L, B, H, S, D] (a
    layer a replay, as the kernels are timed) and the same lengths."""
    pos = torch.arange(S, device=dev)
    lens = lengths[:, None]
    lo = (lens - window) if window else torch.zeros_like(lens)
    mask = ((pos[None] < lens) & (pos[None] >= lo))[:, None, None, :]
    return time_ms(lambda i=0: torch.nn.functional.scaled_dot_product_attention(
        q_hm, k_c[i % L], v_c[i % L], attn_mask=mask), 50)


# (model, kv heads, query heads per kv head, head_dim): K3's decode shapes
K3_SHAPES = [("llama2_7b", 32, 1, 128), ("falcon_7b", 1, 71, 64), ("mixtral_8x7b", 8, 4, 128)]
K3_OFFSETS = [0, 511, 512, 1999]  # 0 and a 512 edge, at B=4; B=1 takes the last alone


def _split(fd, B, H, rep, D, S, quant, span=None) -> dict:
    """The launch's split plan at a shape: the row kernel's keys a split,
    splits a row and shared memory (1/2/4/8 heads per kv head), else the
    split-KV kernel's keys a split and split count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if rep in fd.ROW_REPS:
        p = fd.row_plan(B, H, rep, D, S, quant, span, sm_count=sms)
        return {"splits": p.splits, "keys_per_split": p.kps, "smem": p.smem, "kernel_form": "rows"}
    kps, splits = fd.split_plan(B, H, rep, S, sm_count=sms)
    return {"splits": splits, "keys_per_split": kps, "kernel_form": "split-KV"}


def check_k3(gen, dev, failures):
    """K3 at its three decode shapes (Llama-2-7B, Falcon-7B, Mixtral-8x7B),
    int8 and bf16, no window and a window of 256, B=4 at offsets 0/511/512/
    1999, and Llama-2-7B at B=1, offset 1999 (int8 and bf16), layer i % L of
    the stacked cache: one bf16 step of the plain version, and the written
    rows equal to the plain version's."""
    from aqlm_tpu_torch.ops import flash_decode as fd

    L, S = 4, 2048
    reps = {}
    cases = [(*shape, quant, window, K3_OFFSETS) for shape, quant, window in itertools.product(
        K3_SHAPES, (True, False), (None, 256))]
    cases += [(*K3_SHAPES[0], quant, None, K3_OFFSETS[-1:]) for quant in (True, False)]
    for model, H, rep, D, quant, window, offs in cases:
        B = len(offs)
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
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
        cmp["ok"] = cmp["ok"] and all(torch.equal(a[0], r[0]) for a, r in zip(
            kv + [s for s in sc if s is not None], ref_kv + [s for s in ref_sc if s is not None]))
        ms = time_ms(run, 50)
        plain_ms = time_ms(plain, 5)
        keys = [min(int(o) + 1, window or S) for o in offs]
        row_bytes = 2 * (D + 4) if quant else 2 * 2 * D
        nbytes = sum(keys) * H * row_bytes + 2 * B * H * rep * D * 2 + B * H * row_bytes + B * 4
        b_ms, b_by = bound(nbytes, sum(keys) * H * rep * 4.0 * D)
        library_ms = None if quant else _sdpa_ms(q_hm, kv[0], kv[1], offsets + 1, window, S, L, dev)
        rec = {"phase": "check", "kernel": "flash_decode_write", "model": model,
               "kv": "int8" if quant else "bf16", "window": window, "B": B, "Hkv": H, "rep": rep,
               "D": D, "max_len": S, "offsets": offs, **_split(fd, B, H, rep, D, S, quant, window),
               **cmp, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
               "host_ms": host_ms(run)}
        emit(rec)
        if not cmp["ok"]:
            failures.append(rec)
        if model == "llama2_7b" and quant and window is None and B == 4:
            reps["flash_decode_write"] = rec
        del kv, sc, ref_kv, ref_sc
        torch.cuda.empty_cache()
    return reps


def check_b6(gen, dev, failures):
    """B6 (``flash_decode``, K3's kernels without the row write) at K3's
    three decode shapes, int8 and bf16, lengths 1, 512, 513 and 2048, no window and
    a window of 256 (which skips the tiles outside it), layer i % L of the
    stacked cache; then the unindexed form once. The cache must stay as it
    was. The library time is SDPA over the bf16 twin of the cache (the int8
    cache dequantized)."""
    from aqlm_tpu_torch.ops import flash_decode as fd

    L, B, S = 4, 4, 2048
    lengths = torch.tensor([1, 512, 513, 2048], dtype=torch.int32, device=dev)
    reps = {}
    cases = [(*shape, quant, window, True) for shape, quant, window in itertools.product(
        K3_SHAPES, (True, False), (None, 256))] + [(*K3_SHAPES[0], True, None, False)]
    for model, H, rep, D, quant, window, indexed in cases:
        q = torch.randn((B, 1, H * rep, D), generator=gen, device=dev).to(torch.bfloat16)
        if quant:
            kv = [torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
            sc = [torch.rand((L, B, H, S, 1), generator=gen, device=dev) / 50 for _ in range(2)]
        else:
            kv = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            sc = [None, None]
        ref = [None if t is None else t.clone() for t in kv + sc]
        if indexed:
            run = lambda i=0: fd.flash_decode_attention_indexed(
                q, kv[0], kv[1], sc[0], sc[1], i % L, lengths, window=window)
        else:
            at = lambda t, i: None if t is None else t[i % L]
            run = lambda i=0: fd.flash_decode_attention(
                q, at(kv[0], i), at(kv[1], i), at(sc[0], i), at(sc[1], i), lengths, window=window)
        q_hm = q.reshape(B, H, rep, D)
        layer0 = lambda t: None if t is None else t[0]
        plain = lambda i=0: fd.plain_attend(q_hm, *[layer0(t) for t in kv + sc], lengths,
                                            D ** -0.5, window)
        cmp = compare(run(0).reshape(B, H, rep, D), plain(0))
        cmp["ok"] = cmp["ok"] and all(t is None or torch.equal(t, r) for t, r in zip(kv + sc, ref))
        ms = time_ms(run, 50)
        plain_ms = time_ms(plain, 5)
        twin = kv if not quant else [(kv[j].float() * sc[j]).to(torch.bfloat16) for j in range(2)]
        library_ms = _sdpa_ms(q_hm, twin[0], twin[1], lengths, window, S, L, dev)
        del twin
        keys = [min(int(n), window or S) for n in lengths.tolist()]
        row_bytes = 2 * (D + 4) if quant else 2 * 2 * D
        nbytes = sum(keys) * H * row_bytes + 2 * B * H * rep * D * 2 + B * 4
        b_ms, b_by = bound(nbytes, sum(keys) * H * rep * 4.0 * D)
        rec = {"phase": "check", "kernel": "flash_decode", "model": model,
               "form": "indexed" if indexed else "unindexed",
               "kv": "int8" if quant else "bf16", "window": window, "B": B, "Hkv": H, "rep": rep,
               "D": D, "max_len": S, "lengths": lengths.tolist(),
               **_split(fd, B, H, rep, D, S, quant, fd._b6_span(S, window)),
               **cmp, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
               "library": "scaled_dot_product_attention over the bf16 twin",
               "host_ms": host_ms(run)}
        emit(rec)
        if not cmp["ok"]:
            failures.append(rec)
        if model == "llama2_7b" and quant and window is None and indexed:
            reps["flash_decode"] = rec
        del kv, sc, ref
        torch.cuda.empty_cache()
    return reps


def check_b8(gen, dev, failures):
    """B8 (``kv_write``) into a full-depth Llama-2-7B cache of the int8_short
    run's batch, [32, 4, 32, 2048, 128]: the one-array write of a bf16 cache and the four-array write of the
    int8 one (k, v and both f32 scale planes), bit-identical to the plain
    version (indexed assignment), into layer i % 32. The library time is one
    ``index_put_`` for the one-array write; the four-array write has no
    single call (four ``index_put_`` calls, as an aside). Beside the byte
    bound: ``launch_floor_ms``, a one-element ``fill_`` in the same
    CUDA-graph harness, the floor of one graph kernel node."""
    from aqlm_tpu_torch.ops import kv_write as kw

    L, B, H, S, D = 32, 4, 32, 2048, 128
    offsets = torch.tensor([0, 511, 512, 1999], dtype=torch.int32, device=dev)
    rows, heads = torch.arange(B, device=dev)[:, None], torch.arange(H, device=dev)[None, :]
    off = offsets.long()[:, None]
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda i=0: one.fill_(1.0), 50)
    reps = {}
    for form in ("kv_write", "kv_write4"):
        if form == "kv_write":
            caches = [torch.randn((L, B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)]
            news = [torch.randn((B, H, 1, D), generator=gen, device=dev).to(torch.bfloat16)]
            run = lambda i=0: kw.kv_write_inplace(caches[0], news[0], i % L, offsets)
        else:
            caches = [torch.randint(-127, 128, (L, B, H, S, D), generator=gen, device=dev,
                                    dtype=torch.int32).to(torch.int8) for _ in range(2)] + [
                torch.rand((L, B, H, S, 1), generator=gen, device=dev) for _ in range(2)]
            news = [torch.randint(-127, 128, (B, H, 1, D), generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8) for _ in range(2)] + [
                torch.rand((B, H, 1, 1), generator=gen, device=dev) for _ in range(2)]
            run = lambda i=0: kw.kv_write4_inplace(*caches, *news, i % L, offsets)
        ref = [c.clone() for c in caches]
        plain = lambda i=0: kw.plain([c[i % L] for c in ref], [n[:, :, 0] for n in news], offsets)
        run(0)
        plain(0)
        same = all(torch.equal(c, r) for c, r in zip(caches, ref))
        ms = time_ms(run, 50)
        plain_ms = time_ms(plain, 20)
        puts = lambda i=0: [c[i % L].index_put_((rows, heads, off), n[:, :, 0])
                            for c, n in zip(ref, news)]
        put_ms = time_ms(puts, 50)
        row_bytes = sum(n[0, 0, 0].numel() * n.element_size() for n in news)
        nbytes = 2 * B * H * row_bytes + B * 4  # the new rows read, the cache rows written
        b_ms, b_by = bound(nbytes, 0.0)
        rec = {"phase": "check", "kernel": "kv_write", "form": form,
               "kv": "bf16" if form == "kv_write" else "int8", "cache": [L, B, H, S, D],
               "offsets": offsets.tolist(), "max_abs_err": 0.0 if same else float("inf"),
               "tol": "bit-identical", "ok": same, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": floor_ms,
               "library_ms": put_ms if form == "kv_write" else None,
               "library": "index_put_" if form == "kv_write" else None,
               "library_aside_ms": None if form == "kv_write" else put_ms,
               "host_ms": host_ms(run)}
        emit(rec)
        if not same:
            failures.append(rec)
        if form == "kv_write4":  # the int8_short run's write
            reps["kv_write"] = rec
        del caches, ref
        torch.cuda.empty_cache()
    return reps


def check_b16(gen, dev, failures):
    """B16 (``gather_wraps``): the probe's gather of the (8, 128) f32 table at
    indices 128..255 by warp shuffles, and a random table at random indices
    0..255, against the plain gather at idx % 128 (bit-identical); the probe
    itself must answer True on the card. No one PyTorch call gathers at
    indices past the table: no library time."""
    from aqlm_tpu_torch.ops import kernels as k

    tab, idx = k.wrap_probe_inputs(dev)
    rand = torch.randn((8, 128), generator=gen, device=dev)
    ridx = torch.randint(0, 256, (8, 128), generator=gen, device=dev, dtype=torch.int32)
    exact = (torch.equal(k.gather_wraps_launch(tab, idx), k.gather_wraps_plain(tab, idx))
             and torch.equal(k.gather_wraps_launch(rand, ridx), k.gather_wraps_plain(rand, ridx)))
    k._GATHER_WRAPS.pop("cuda", None)
    wraps = k.gather_wraps(dev)
    run = lambda i=0: k.gather_wraps_launch(tab, idx)
    b_ms, b_by = bound(3 * 8 * 128 * 4, 0)
    rec = {"phase": "check", "kernel": "gather_wraps", "rows": 8, "lanes": 128,
           "max_abs_err": float((run(0) - k.gather_wraps_plain(tab, idx)).abs().max()),
           "tol": "bit-identical", "gather_wraps": wraps, "ok": exact and wraps,
           "ms": time_ms(run, 50), "plain_ms": time_ms(lambda i=0: k.gather_wraps_plain(tab, idx), 50),
           "bound_ms": b_ms, "bound_by": b_by, "library": "none", "library_ms": None,
           "host_ms": host_ms(run)}
    emit(rec)
    if not rec["ok"]:
        failures.append(rec)
    return {"gather_wraps": rec}


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
    if dataclasses.is_dataclass(node):  # a LoraLinear's base included
        return dataclasses.replace(node, **{
            f.name: _to(getattr(node, f.name), dev) for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)
            or hasattr(getattr(node, f.name), "data_fields")})
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
    from aqlm_tpu_torch.serve import ServeConfig
    from aqlm_tpu_torch.serve.engine import serving_params

    model, mode, scheme = RUNS[run]
    cfg = model_config(model)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = run_params(dev, run, cfg2, seed=1)
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
    ok = res[kv]["ok"]
    if run == "codes_1x16":
        # the flagship's own shape (aqlm_tpu's __graft_entry__: llama.forward
        # over 128 tokens, no cache): the GEMM on the card against the CPU
        from aqlm_tpu_torch.models import llama

        ids128 = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 128)))
        with torch.inference_mode():
            got = llama.forward(params, cfg2, ids128.to(dev))[0][0].float().cpu()
            want = llama.forward(_to(params, torch.device("cpu")), cfg2, ids128)[0][0].float()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        entry_ok = bool(torch.isfinite(got).all()) and err <= 3e-2 * scale
        aside["llama_forward_128"] = {"max_abs_err": err, "max_rel_err": err / scale,
                                      "argmax_agree": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                                      "ok": entry_ok}
        ok = ok and entry_ok
    return {"phase": "reference", "run": run, "model": model, "mode": mode, "scheme": scheme,
            "lm_head_int8": serve.lm_head_int8, "layers": 2,
            "hidden": cfg.hidden_size, "max_len": max_len, "prefill_tokens": 20,
            "decode_steps": 3, "kv": kv, **res[kv], "ok": ok,
            "tol": "max|cuda - cpu| <= 3e-2 * max|cpu|", **aside}


# ---------------------------------------------------------------------------
# phase 4: Engine.generate at full width, the flagship run at full depth
# ---------------------------------------------------------------------------

# run -> (model, mode, scheme): the engine runs, in order
RUNS = {"codes": ("llama2_7b", "codes", "2x8g8"), "int8": ("llama2_7b", "int8", "2x8g8"),
        "int4": ("llama2_7b", "int4", "2x8g8"), "mixtral_int8": ("mixtral_8x7b", "int8", "2x8g8"),
        "mixtral_int4": ("mixtral_8x7b", "int4", "2x8g8"),
        "falcon_codes": ("falcon_7b", "codes", "2x8g8"),
        "mixtral_codes": ("mixtral_8x7b", "codes", "2x8g8"),
        "codes_1x16": ("llama2_7b", "codes", "1x16g8")}
# the kernels each engine run must launch; the other paths' must stay at 0
PATH_KERNELS = {"codes": ("lut_gemv", "gather_prefill", "flash_decode_write"),
                "int8": ("int8_matmul", "flash_decode_write"),
                "int4": ("int4_matmul", "flash_decode_write"),
                "mixtral_int8": ("int8_matmul", "int8_moe_matmul", "flash_decode_write"),
                "mixtral_int4": ("int4_matmul", "int4_moe_matmul", "flash_decode_write"),
                "falcon_codes": ("lut_gemv", "gather_prefill", "onehot_matmul",
                                 "flash_decode_write"),
                "mixtral_codes": ("lut_gemv", "gather_prefill", "lut_moe_gemv",
                                  "moe_gather_prefill", "flash_decode_write"),
                "codes_1x16": ("gather16_gemv", "gather16_gemm", "flash_decode_write")}
# the depth of every engine run but the first (Llama-2-7B in 2x8 codes, at
# full depth) and of int8_short: their launch gates follow cfg.num_layers
ENGINE_CUT_LAYERS = 8


def model_config(model):
    from aqlm_tpu_torch.models.falcon import FalconConfig
    from aqlm_tpu_torch.models.llama import ModelConfig
    from aqlm_tpu_torch.models.mixtral import MixtralConfig

    return {"llama2_7b": ModelConfig.llama2_7b, "mixtral_8x7b": MixtralConfig.mixtral_8x7b,
            "falcon_7b": FalconConfig.falcon_7b}[model]()


def engine_config(run):
    """The run's model config: full depth for the first run, ENGINE_CUT_LAYERS
    layers for the others."""
    cfg = model_config(RUNS[run][0])
    return cfg if run == "codes" else dataclasses.replace(cfg, num_layers=ENGINE_CUT_LAYERS)


def engine_serve_config(run):
    """Mixtral loads with donate_params, as it must at full depth: there its
    43.6 GiB of int8 weights and their stacked copies would not fit the
    card's 80 GB together (its ~24 GB in int4 load the same way)."""
    from aqlm_tpu_torch.serve import ServeConfig

    model, mode, _ = RUNS[run]
    return ServeConfig(max_batch=4, max_len=2048, kv_quantized=True, lm_head_int8=mode == "int8",
                       donate_params=model == "mixtral_8x7b")


def run_params(dev, run, cfg, seed):
    """The run's random quantized params on the card. A Mixtral in codes mode
    has its experts stacked by the caller (the Engine stacks int8 and int4
    experts itself, and serves codes experts stacked or per expert), each
    layer's per-expert weights freed as their stacked copy appears."""
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.models import mixtral
    from aqlm_tpu_torch.models.quantize import random_quantized_params

    model, mode, scheme = RUNS[run]
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                     AqlmScheme.parse(scheme), mode=mode, device=dev)
    if model == "mixtral_8x7b" and mode == "codes":
        params["layers"] = [mixtral.stack_experts(l, cfg, donate=True) for l in params["layers"]]
    return params


def engine_run(dev, run):
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import Engine, SamplingParams

    model, mode, scheme = RUNS[run]
    cfg = engine_config(run)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = run_params(dev, run, cfg, seed=0)
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
    prefill_chunks = []
    inner_prefill = engine._prefill

    def counted_prefill(*args):
        prefill_chunks.append(len(args[0]))
        return inner_prefill(*args)

    engine._prefill = counted_prefill
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
    # decode forwards: K3 runs once per layer of each (every run takes the flash rule);
    # prefill forwards: one per chunk, each padded to a bucket of at least 64 rows
    decode_forwards = launches["flash_decode_write"] / cfg.num_layers
    prefill_forwards = len(prefill_chunks)
    if run == "mixtral_codes":
        # decode: qkv and o per layer on K1, gate, up and down on K1's MoE
        # instance; prefill: qkv and o on K2, gate, up and down on K2's f32
        # instance, all experts in one launch
        per_forward = {"decode_forwards": decode_forwards, "prefill_forwards": prefill_forwards,
                       "moe_k1_per_decode_forward": launches["lut_moe_gemv"] / decode_forwards,
                       "moe_k2_per_prefill_forward":
                           launches["moe_gather_prefill"] / prefill_forwards}
        ran = (ran and per_forward["moe_k1_per_decode_forward"] == 3 * cfg.num_layers
               and per_forward["moe_k2_per_prefill_forward"] == 3 * cfg.num_layers
               and launches["lut_gemv"] == 2 * cfg.num_layers * decode_forwards
               and launches["gather_prefill"] == 2 * cfg.num_layers * prefill_forwards)
    elif run == "codes_1x16":
        # every forward: q, k, v, o, gate, up, down per layer, unfused
        per_forward = {"decode_forwards": decode_forwards, "prefill_forwards": prefill_forwards,
                       "gemv_per_decode_forward": launches["gather16_gemv"] / decode_forwards,
                       "gemm_per_prefill_forward": launches["gather16_gemm"] / prefill_forwards}
        ran = (ran and per_forward["gemv_per_decode_forward"] == 7 * cfg.num_layers
               and per_forward["gemm_per_prefill_forward"] == 7 * cfg.num_layers)
    elif model == "mixtral_8x7b":
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
           "scheme": scheme, "mode": mode, "lm_head_int8": serve.lm_head_int8,
           "donate_params": serve.donate_params, "kv": "int8",
           "max_batch": serve.max_batch, "max_len": serve.max_len,
           "prompt_lengths": lengths, "new_tokens": new_tokens, "build_s": build_s,
           "prefill_tok_s": sum(lengths) / prefill_s, "prefill_s": prefill_s,
           "decode_tok_s": decode_tok / decode_s if decode_s else None,
           "decode_steps_timed": len(decode_steps), "decode_tokens_timed": decode_tok,
           "generate_s": total_s, "steps": len(steps),
           "build_peak_mem_gib": build_peak_gib,
           "serve_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "forms": {k: dict(v.forms) for k, v in _build.KERNELS.items()
                                           if v.forms},
           **per_forward, "prefix_hits": engine.prefix_stats["hits"],
           "first_tokens": [o[:4] for o in out], "ok": ok and ran and others}
    t0 = time.perf_counter()
    rec["profile"] = profile_decode(engine, cfg, rng)
    rec["profile"]["seconds"] = time.perf_counter() - t0
    # the wrappers close over the engine: a cycle that would keep it alive
    del engine.step, engine._prefill
    del engine
    torch.cuda.empty_cache()
    return rec


PROFILE_NEW_TOKENS = 4


def profile_decode(engine, cfg, rng) -> dict:
    """Device time by kernel over a short decode window (4 rows of 64-token
    prompts, 4 new tokens), from torch.profiler, beside its wall time. The
    window is short because ``key_averages`` walks every recorded event: at
    16 new tokens it took 28-42 s a run on the H100's host, at 8 21-32 s."""
    from torch.profiler import ProfilerActivity, profile

    from aqlm_tpu_torch.serve import SamplingParams

    prompts = [rng.integers(0, cfg.vocab_size, 64) for _ in range(4)]
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompts, SamplingParams(max_new_tokens=PROFILE_NEW_TOKENS))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    averages = prof.key_averages()  # aggregated once: it walks every recorded event
    # device-side entries only: an aten op's entry repeats its kernels' time
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    events = [e for e in averages
              if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    # the host side: torch ops by their own CPU time (the profiler's overhead included)
    host = [e for e in averages if getattr(e, "device_type", None) == DeviceType.CPU]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return {"window": f"4 x 64-token prompts, {PROFILE_NEW_TOKENS} new tokens", "wall_ms": wall_ms,
            "device_ms": total_ms, "device_busy_share": total_ms / wall_ms,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "calls": e.count} for e in top],
            "host_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "host_top": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host_top],
            "aggregate_s": time.perf_counter() - t0}


PATH_KERNELS["int8_short"] = ("int8_matmul", "kv_write")


def count_syncs(fn, *args):
    """(fn(*args), the synchronising CUDA calls it made), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (a count taken
    inside it keeps its calls to itself)."""
    prev = torch.cuda.get_sync_debug_mode()  # a count inside another leaves the outer one on
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("called a synchronizing" in str(w.message) for w in caught)
SHORT_LENGTHS = [64, 150, 270, 380]  # the int8_short run's prompts
SHORT_REPEATS = 2  # timed generate calls per decode_chunk setting


def int8_short_run(dev) -> dict:
    """Llama-2-7B in int8 with the int8 lm_head at full width and
    ENGINE_CUT_LAYERS layers, under
    ServeConfig(max_batch=4, max_len=512, kv_quantized=True): the default
    rule keeps K3 off at this max_len, so a decode forward writes its rows
    with B8 (one kv_write4 launch per layer) and attends by the plain
    attention. Four prompts of 64-380 tokens, 64 new tokens each, greedy,
    once with decode_chunk 1 and once with 8 (each engine freed before the
    next is built): the tokens must be identical, B8 must launch exactly once
    per layer per decode forward (so never in prefill), K3 and B6 never, and the
    forwards of each step and each chunk (``Engine._decode_chunk``, between
    the inputs' upload and the tokens' read-back) must make no synchronising
    call (counted by ``torch.cuda.set_sync_debug_mode("warn")``, a deliberate
    read-back as its control). Each engine generates the same prompts
    SHORT_REPEATS times; reports each setting's decode tok/s (median and
    runs) and the chunked engine's device-busy share."""
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

    cfg = dataclasses.replace(model_config("llama2_7b"), num_layers=ENGINE_CUT_LAYERS)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SHORT_LENGTHS]
    warm = [rng.integers(0, cfg.vocab_size, 64)]
    new_tokens = 64
    rec = {"phase": "engine", "run": "int8_short", "model": "llama2_7b",
           "layers": cfg.num_layers, "scheme": "2x8g8", "mode": "int8", "lm_head_int8": True,
           "kv": "int8", "max_batch": 4, "max_len": 512, "prompt_lengths": SHORT_LENGTHS,
           "new_tokens": new_tokens, "launches": {}}
    # the counter's control: one deliberate read-back must count
    rec["sync_counter_control"] = count_syncs(lambda: torch.ones(1, device=dev).sum().item())[1]
    outs, ok = {}, rec["sync_counter_control"] >= 1
    for chunk in (1, 8):
        params = run_params(dev, "int8", cfg, seed=0)
        engine = Engine(params, cfg, ServeConfig(max_batch=4, max_len=512, kv_quantized=True,
                                                 lm_head_int8=True, decode_chunk=chunk))
        del params
        engine.generate(warm, SamplingParams(max_new_tokens=10))  # first calls, one chunk
        steps, forwards, syncs = [], [0], []
        inner_step, inner_fwd, inner_chunk = engine.step, engine._forward_sample, engine._decode_chunk

        def timed_step():
            n_pending = len(engine._pending)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            emitted = inner_step()
            torch.cuda.synchronize()
            n_tok = sum(len(v) if isinstance(v, list) else 1 for v in emitted.values())
            steps.append((time.perf_counter() - s0, len(engine._pending) == n_pending, n_tok))
            return emitted

        def counted_forward(*args):
            forwards[0] += 1
            return inner_fwd(*args)

        def sync_checked_chunk(*args):
            out, n = count_syncs(inner_chunk, *args)
            syncs.append(n)
            return out

        engine.step, engine._forward_sample = timed_step, counted_forward
        engine._decode_chunk = sync_checked_chunk
        # the same generate SHORT_REPEATS times: one chunk-8 run times only 7
        # chunks, and the host's speed moves a step between runs. From the
        # second on, prompts reuse the rows the one before left (prefix
        # cache), as in the other engine, so run i's tokens match its run i
        _build.reset_launch_counts()
        tok_s, gen_s, runs_out = [], [], []
        for _ in range(SHORT_REPEATS):
            steps.clear()
            t0 = time.perf_counter()
            runs_out.append(engine.generate(prompts, SamplingParams(max_new_tokens=new_tokens)))
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            decode = [st for st in steps if st[1] and st[2] > 0]
            tok_s.append(sum(st[2] for st in decode) / sum(st[0] for st in decode))
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        for k, n in launches.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + n
        out = runs_out[0]
        tag = f"chunk{chunk}"
        rec[tag] = {"decode_chunk": chunk, "decode_tok_s": statistics.median(tok_s),
                    "decode_tok_s_runs": tok_s, "decode_steps_timed_per_run": len(decode),
                    "decode_tokens_timed_per_run": sum(st[2] for st in decode),
                    "generate_s_runs": gen_s, "steps_per_run": len(steps),
                    "decode_forwards": forwards[0],
                    "kv_write_per_decode_forward": launches["kv_write"] / forwards[0],
                    "decode_calls": len(syncs), "syncs": sum(syncs),
                    "first_tokens": [o[:4] for o in out]}
        outs[chunk] = runs_out
        ok = (ok and all(len(o) == new_tokens and all(0 <= t < cfg.vocab_size for t in o)
                         for r in runs_out for o in r)
              and launches["kv_write"] == cfg.num_layers * forwards[0]
              and launches["int8_matmul"] > 0
              and all(n == 0 for k, n in launches.items() if k not in PATH_KERNELS["int8_short"])
              and len(syncs) > 0 and all(n == 0 for n in syncs))
        if chunk > 1:
            engine.step, engine._forward_sample, engine._decode_chunk = (
                inner_step, inner_fwd, inner_chunk)
            t0 = time.perf_counter()
            rec["profile"] = profile_decode(engine, cfg, rng)
            rec["profile"]["seconds"] = time.perf_counter() - t0
        del engine.step, engine._forward_sample, engine._decode_chunk
        del engine
        torch.cuda.empty_cache()
    rec["tokens_identical"] = outs[1] == outs[8]  # every run, decode_chunk 1 against 8
    rec["decode_tok_s"] = rec["chunk8"]["decode_tok_s"]
    rec["ok"] = ok and rec["tokens_identical"]
    return rec


# ---------------------------------------------------------------------------
# phase 4b: speculative decoding at full Llama-2-7B width and depth
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_NEW = 32
SPEC_LENGTHS = [16, 70, 130, 200]  # the spec runs' prompts
SPEC_DRAFT_LAYERS = 4  # spec_trunc's draft: the target's first layers
SPEC_SAMPLED = dict(temperature=0.8, top_p=0.95)
SPEC_PROJS = 4  # launches a layer of a 2x8 codes Llama: fused qkv, o, fused gate/up, down
SPEC_RUNS = ("spec_self", "spec_self_sampled", "spec_trunc", "spec_plain")
for _run in SPEC_RUNS:
    PATH_KERNELS[_run] = PATH_KERNELS["codes"]


def spec_serve_config():
    """ServeConfig of the spec runs: 4 slots, 512 rows, buckets of 64 and 512
    ids; the adaptive drop off (``spec_min_acceptance`` 0), so every step of
    a run is a round and the truncated draft's acceptance is measured over
    the whole run."""
    from aqlm_tpu_torch.serve import ServeConfig

    return ServeConfig(max_batch=4, max_len=512, prefill_buckets=(64, 512),
                       spec_min_acceptance=0.0)


def spec_launch_formula(buckets: list, layers: int, draft_layers: int, target_chunks: int,
                        draft_chunks: int, k: int = SPEC_K, projs: int = SPEC_PROJS) -> dict:
    """K1, K2 and K3 launches of a speculative Engine run, from the code:
    every round (``buckets``: its slot bucket b, one entry a round) runs k+1
    single-token draft forwards (K1 on each projection of each draft layer,
    K3 once a draft layer: max_len 512 takes flash decode) and one [b, k+1]
    target forward, on K1 at b (k+1) <= 8 rows and on K2 past them (its
    attention the plain one, no kernel); every prefill chunk (padded to 64
    or 512 rows) runs K2 on each projection of the model it fills. The
    head is dense."""
    small = sum(1 for b in buckets if b * (k + 1) <= 8)
    return {"lut_gemv": projs * draft_layers * (k + 1) * len(buckets) + projs * layers * small,
            "gather_prefill": projs * (layers * target_chunks + draft_layers * draft_chunks)
            + projs * layers * (len(buckets) - small),
            "flash_decode_write": draft_layers * (k + 1) * len(buckets)}


def _teacher_forced_gap(params, cfg, prompts, answers, dev) -> dict:
    """Each emitted token's logit against its position's largest, from one
    teacher-forced ``forward_stacked`` of the target over prompt + answer:
    the largest gap over the answers, as a share of max|logit|."""
    from aqlm_tpu_torch.models.stacked import forward_stacked

    worst, worst_rel, argmax_same, n = 0.0, 0.0, 0, 0
    for p, a in zip(prompts, answers):
        ids = torch.as_tensor(np.concatenate([p, a]), device=dev)[None]
        logits = forward_stacked(params, cfg, ids)[0][0, len(p) - 1:-1].float()
        got = logits.gather(-1, torch.as_tensor(a, device=dev)[:, None])[:, 0]
        gap = logits.max(-1).values - got
        rel = float((gap / logits.abs().max(-1).values).max())
        worst, worst_rel = max(worst, float(gap.max())), max(worst_rel, rel)
        argmax_same += int((gap == 0).sum())
        n += len(a)
    return {"max_gap": worst, "max_gap_rel": worst_rel, "argmax_share": argmax_same / n,
            "ok": worst_rel <= 3e-2, "tol": "logit(token) >= max logit - 3e-2 max|logit|, "
            "each position"}


def _time_steps(engine, steps: list) -> None:
    """Wrap ``engine.step`` (an instance attribute; ``del engine.step``
    undoes it) to append (seconds, no request admitted, tokens emitted)."""
    inner = engine.step

    def timed_step():
        n_pending = len(engine._pending)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        emitted = inner()
        torch.cuda.synchronize()
        n_tok = sum(len(v) if isinstance(v, list) else 1 for v in emitted.values())
        steps.append((time.perf_counter() - s0, len(engine._pending) == n_pending, n_tok))
        return emitted

    engine.step = timed_step


def _decode_tok_s(steps: list) -> float:
    """Tokens over seconds of the steps that admitted nothing."""
    decode = [s for s in steps if s[1] and s[2] > 0]
    return sum(s[2] for s in decode) / sum(s[0] for s in decode)


def _spec_generate(engine, prompts, sampling) -> dict:
    """One generate of the spec engine with every count read over it: the
    launches, the rounds' slot buckets, the prefill chunks of each model,
    the synchronising calls of each round (``_spec_round``: the draft loop,
    the verify, the accept) and of each step (with its uploads and its
    read-back), and the seconds of each step. Each round's first rejected
    proposal of an active slot is also measured against the verify's
    logits at its position (``rejected_gap``: how far the proposal's logit
    lies below the position's largest, a share of max|logit|), from
    tensors kept on the card until the run ends."""
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import speculative

    rec = {"buckets": [], "round_syncs": [], "step_syncs": [], "target_chunks": 0,
           "draft_chunks": 0}
    steps, verify, active = [], [], []
    inner_accept = speculative.batched_accept

    def recorded_accept(logits, q_rows, draft_toks, *args, **kw):
        out = inner_accept(logits, q_rows, draft_toks, *args, **kw)
        lg = logits[:, :draft_toks.shape[1]].float()
        gap = lg.max(-1).values - lg.gather(-1, draft_toks.long()[..., None])[..., 0]
        verify.append((gap / lg.abs().max(-1).values, out[0]))
        return out

    inner_round, inner_step = engine._spec_round, engine._spec_step
    inner_prefill, inner_draft = engine._prefill, engine._prefill_draft

    def counted_round(*args):
        rec["buckets"].append(args[6])
        active.append(sorted(engine._active))
        out, n = count_syncs(inner_round, *args)
        rec["round_syncs"].append(n)
        return out

    def counted_step():
        out, n = count_syncs(inner_step)
        rec["step_syncs"].append(n)
        return out

    def counted_prefill(*args):
        rec["target_chunks"] += 1
        return inner_prefill(*args)

    def counted_draft(*args):
        rec["draft_chunks"] += 1
        return inner_draft(*args)

    engine._spec_round, engine._spec_step = counted_round, counted_step
    engine._prefill, engine._prefill_draft = counted_prefill, counted_draft
    _time_steps(engine, steps)
    speculative.batched_accept = recorded_accept
    try:
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(prompts, sampling)
        torch.cuda.synchronize()
        rec["generate_s"] = time.perf_counter() - t0
        rec["launches"] = {k: v.launches for k, v in _build.KERNELS.items()}
    finally:
        speculative.batched_accept = inner_accept
        del engine._spec_round, engine._spec_step, engine._prefill, engine._prefill_draft
        del engine.step
    gaps = []
    for (rel, n_acc), slots in zip(verify, active):
        rel, n_acc = rel.cpu(), n_acc.cpu()
        gaps += [float(rel[s, n_acc[s]]) for s in slots if n_acc[s] < rel.shape[1]]
    rec["rejections"] = len(gaps)
    rec["rejected_gap_max_rel"] = max(gaps, default=0.0)
    rec["decode_tok_s"], rec["steps"] = _decode_tok_s(steps), len(steps)
    rec["rounds"] = len(rec["buckets"])
    return out, rec


def spec_run(dev) -> dict:
    """Speculative decoding on Llama-2-7B at full width and depth in 2x8
    codes, drawn well-scaled (``weight_scale=1.0``), bf16 KV cache,
    ``spec_serve_config()``, spec_k 4, SPEC_LENGTHS prompts, SPEC_NEW new
    tokens each: ``spec_self`` (the draft the same params) greedy and then
    sampled (``spec_self_sampled``, temperature 0.8, top_p 0.95),
    ``spec_trunc`` (the target's first SPEC_DRAFT_LAYERS layers, its
    embedding, final norm and head) greedy, and ``spec_plain``, the Engine
    without a draft. Gates: every greedy spec answer's tokens within 3e-2
    max|logit| of their position's largest logit in one teacher-forced
    forward of the target; the self-draft's acceptance >= 0.9 sampled, and
    greedy every proposal it had rejected within 3e-2 max|logit| of the
    largest logit of the verify at its position (greedy acceptance needs the
    draft's argmax to equal the verify's bit for bit: the draft steps run
    K1 and K3, a verify of 20 rows K2 and the plain attention, and this
    draw's logits, 32000 Gaussians a position, hold near-ties those routes
    flip; the greedy acceptance is recorded); each spec run's K1/K2/K3 launches equal to
    ``spec_launch_formula`` and nothing else launched; no synchronising
    call inside a round and at most three a step (the two uploads of its
    inputs, the read-back); the plain Engine's single-step logits with
    ``use_flash_decode`` True and False within 3e-2 max|logit| (the draw at
    32 layers, the check the tolerance gate rests on). Records tokens/s
    (spec and plain decode), the trunc draft's acceptance, the share of
    tokens equal to the plain Engine's and peak memory."""
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import Engine, SamplingParams

    cfg = model_config("llama2_7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                     AqlmScheme.parse("2x8g8"), mode="codes", device=dev,
                                     weight_scale=1.0)
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SPEC_LENGTHS]
    greedy = SamplingParams(max_new_tokens=SPEC_NEW)
    sampled = SamplingParams(max_new_tokens=SPEC_NEW, **SPEC_SAMPLED)
    serve = spec_serve_config()
    rec = {"phase": "spec", "model": "llama2_7b", "layers": cfg.num_layers, "scheme": "2x8g8",
           "mode": "codes", "weight_scale": 1.0, "kv": "bf16", "spec_k": SPEC_K,
           "max_batch": serve.max_batch, "max_len": serve.max_len,
           "prefill_buckets": list(serve.prefill_buckets), "prompt_lengths": SPEC_LENGTHS,
           "new_tokens": SPEC_NEW, "draw_s": draw_s, "runs": {}}
    runs, answers, ok = rec["runs"], {}, True
    drafts = {"spec_self": (params, cfg),
              "spec_trunc": ({**params, "layers": params["layers"][:SPEC_DRAFT_LAYERS]},
                             dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS))}
    for name, (dparams, dcfg) in drafts.items():
        t0 = time.perf_counter()
        engine = Engine(params, cfg, serve, draft_params=dparams, draft_cfg=dcfg, spec_k=SPEC_K)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        engine.generate(prompts[:1], SamplingParams(max_new_tokens=SPEC_K + 2))  # first calls
        for run, sampling in ((name, greedy),) + (((f"{name}_sampled", sampled),)
                                                    if name == "spec_self" else ()):
            engine.spec_stats = {"proposed": 0, "accepted": 0}
            out, r = _spec_generate(engine, prompts, sampling)
            st = engine.spec_stats
            want = spec_launch_formula(r["buckets"], cfg.num_layers, dcfg.num_layers,
                                       r["target_chunks"], r["draft_chunks"])
            r.update(build_s=build_s, draft_layers=dcfg.num_layers, spec_stats=dict(st),
                     acceptance=st["accepted"] / max(st["proposed"], 1), launch_formula=want,
                     sampling=dataclasses.asdict(sampling), first_tokens=[o[:4] for o in out],
                     tokens_per_round=sum(len(o) - 1 for o in out) / max(r["rounds"], 1))
            r["launches_as_formula"] = (
                all(r["launches"][k] == n for k, n in want.items())
                and all(n == 0 for k, n in r["launches"].items() if k not in want))
            r["syncs_ok"] = (max(r["round_syncs"]) == 0 and max(r["step_syncs"]) <= 3)
            r["tokens_ok"] = all(len(o) == SPEC_NEW and all(0 <= t < cfg.vocab_size for t in o)
                                 for o in out)
            run_ok = r["launches_as_formula"] and r["syncs_ok"] and r["tokens_ok"]
            if sampling.temperature == 0:
                with torch.inference_mode():
                    r["exactness"] = _teacher_forced_gap(engine.params, cfg, prompts, out, dev)
                run_ok = run_ok and r["exactness"]["ok"]
                answers[run] = out
            if name == "spec_self":
                # sampled: acceptance; greedy: every rejection a near-tie of
                # the verify's logits (a random draw's logits hold many;
                # routes that round apart flip them, see spec_run)
                run_ok = run_ok and (r["acceptance"] >= 0.9 if sampling.temperature > 0
                                     else r["rejected_gap_max_rel"] <= 3e-2)
            r["ok"] = run_ok
            runs[run] = r
            ok = ok and run_ok
        del engine
        torch.cuda.empty_cache()

    # the plain Engine on the same prompts, and flash decode against the plain
    # attention at this depth
    engine = Engine(params, cfg, serve)
    del params, drafts
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    steps = []
    _time_steps(engine, steps)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    plain = engine.generate(prompts, greedy)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del engine.step
    runs["spec_plain"] = {"generate_s": gen_s,
                          "launches": {k: v.launches for k, v in _build.KERNELS.items()},
                          "decode_tok_s": _decode_tok_s(steps),
                          "first_tokens": [o[:4] for o in plain]}
    runs["spec_plain"]["ok"] = (all(runs["spec_plain"]["launches"][k] > 0
                                    for k in PATH_KERNELS["spec_plain"])
                                and all(n == 0 for k, n in runs["spec_plain"]["launches"].items()
                                        if k not in PATH_KERNELS["spec_plain"]))
    ok = ok and runs["spec_plain"]["ok"]
    rec["same_as_plain"] = {run: sum(a == b for o, p in zip(out, plain) for a, b in zip(o, p))
                            / sum(len(p) for p in plain) for run, out in answers.items()}
    with torch.inference_mode():
        cache = init_kv_cache(cfg, len(prompts), serve.max_len, device=dev)
        last = []
        for b, p in enumerate(prompts):
            lg, _ = forward_stacked(engine.params, cfg, torch.as_tensor(p, device=dev)[None],
                                    cache=cache.rows(b, b + 1), cache_offset=0)
            last.append(int(lg[0, -1].argmax()))
        toks = torch.as_tensor(last, device=dev)[:, None]
        offs = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
        flash = forward_stacked(engine.params, cfg, toks, cache=cache, cache_offset=offs,
                                use_flash_decode=True)[0][:, -1].float()
        plain_attn = forward_stacked(engine.params, cfg, toks, cache=cache, cache_offset=offs,
                                     use_flash_decode=False)[0][:, -1].float()
    err, scale = float((flash - plain_attn).abs().max()), float(plain_attn.abs().max())
    rec["flash_vs_plain"] = {"max_abs_err": err, "max_rel_err": err / scale,
                             "argmax_agree": float((flash.argmax(-1) == plain_attn.argmax(-1))
                                                   .float().mean()),
                             "ok": bool(torch.isfinite(flash).all()) and err <= 3e-2 * scale,
                             "tol": "max|flash - plain| <= 3e-2 max|plain|, 32 layers"}
    ok = ok and rec["flash_vs_plain"]["ok"]
    del engine, cache
    torch.cuda.empty_cache()
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["ok"] = ok
    return rec


# ---------------------------------------------------------------------------
# phase 5: calibration (cli.quantize) at full Llama-2-7B width, then serving its result
# ---------------------------------------------------------------------------

# the calibrated checkpoint (1.1 GB: the f32 embedding and head) goes to the
# git-ignored build/ directory, not chiprun_out/ (which holds the run's small
# reports), and is deleted once served
CALIB_DIR = os.path.join("build", "calib_checkpoint")
CALIB_ARGS = dict(nsamples=16, model_seqlen=512, batch_size=4, init_max_iter=10, max_epochs=2,
                  steps_per_epoch=10, finetune_max_epochs=1, finetune_batch_size=1)
# every kernel that is not the calibration's must stay at 0 during it
PATH_KERNELS["calibration"] = ("dequantize_onehot", "cb_grad_segment")
PATH_KERNELS["serve_calibrated"] = ("lut_gemv", "gather_prefill", "flash_decode_write")


def calib_launch_formula(layers: int, projs: int = 7) -> dict:
    """B13 and B14 launches the calibration run must make: per projection
    and Adam step one forward dequant (B13) and one backward (B14), plus one
    B13 for the final MSE; per block finetune step (samples / batch, no
    validation) a forward and a backward through each projection; per
    propagate batch a forward. The activation capture runs the dense block."""
    a = CALIB_ARGS
    adam = a["max_epochs"] * a["steps_per_epoch"]  # no MSE tolerance: every epoch runs
    ft = a["finetune_max_epochs"] * (a["nsamples"] // a["finetune_batch_size"])
    prop = -(-a["nsamples"] // a["batch_size"])
    return {"dequantize_onehot": layers * projs * (adam + 1 + ft + prop),
            "cb_grad_segment": layers * projs * (adam + ft),
            "adam_steps_per_projection": adam, "finetune_steps_per_layer": ft,
            "propagate_batches_per_layer": prop}


def calibration_run(dev) -> dict:
    """``aqlm_tpu_torch.cli.quantize.main`` in-process on random:llama2_7b:2
    (two layers at full width, random weights from seed 0) in 2x8 g8 on
    ``random`` calibration ids, saving to ``CALIB_DIR``. Gates: every
    projection's final MSE finite and below its k-means-init MSE; each
    layer's out_loss finite; B13 and B14 launched exactly as
    ``calib_launch_formula`` says; no other kernel launched."""
    from aqlm_tpu_torch.cli import quantize as cq
    from aqlm_tpu_torch.ops import _build

    layers = 2
    argv = [f"random:llama2_7b:{layers}", "random", "--num_codebooks", "2",
            "--nbits_per_codebook", "8", "--in_group_size", "8", "--save", CALIB_DIR]
    for k, v in CALIB_ARGS.items():
        argv += [f"--{k}", str(v)]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    stats = cq.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    want = calib_launch_formula(layers)
    projs = stats["projections"]
    mse_ok = all(np.isfinite(p["final_mse"]) and p["final_mse"] < p["init_mse"] for p in projs)
    loss_ok = all(np.isfinite(x) for x in stats["out_loss"]) and len(stats["out_loss"]) == layers
    count_ok = all(launches[k] == want[k] for k in PATH_KERNELS["calibration"])
    others = all(n == 0 for k, n in launches.items() if k not in PATH_KERNELS["calibration"])
    return {"phase": "calibration", "argv": argv, "layers": layers, "hidden": 4096,
            "intermediate": 11008, "seconds_total": total_s, "seconds_by_part": stats["seconds"],
            "quantization_time_s": stats["quantization_time_s"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "avg_bits": stats["avg_bits"], "out_loss": stats["out_loss"],
            "projections": projs, "launches": launches, "launch_formula": want,
            "mse_below_init": mse_ok, "out_loss_finite": loss_ok, "launches_match": count_ok,
            "no_other_kernel": others, "ok": mse_ok and loss_ok and count_ok and others}


# ---------------------------------------------------------------------------
# phase 5b: PV-tuning (cli.finetune) of the calibrated checkpoint against its teacher
# ---------------------------------------------------------------------------

PV_DIR = os.path.join("build", "pv_checkpoint")  # the tuned student and its training state
PV_ARGS = dict(dataset="random", nsamples=16, model_seqlen=512, batch_size=4, microbatch_size=2,
               total_steps=8, code_update_every=2)
PV_WINDOW_STEPS = 4  # the --st_window 1 --offload_teacher run
PV_MAX_CHANGE = 1e-2  # the CLI's default --max_code_change_per_step
PATH_KERNELS["pv"] = ("dequantize_onehot", "cb_grad_segment")
PATH_KERNELS["pv_window"] = PATH_KERNELS["pv"]
PV_SCAN_STEPS = 4  # each --scan_blocks run's steps (the pv runs' first 4 are its reference)
for _run in ("pv_scan", "pv_scan_window", "pv_scan_depth"):
    PATH_KERNELS[_run] = PATH_KERNELS["pv"]


def _v_calls(run: str, steps: int, layers: int, projs: int = 7) -> int:
    """Beam-search calls of a ``cli.finetune`` run's V steps in its first
    ``steps`` steps: every ST-active projection a V step (a window of one
    layer with ``--st_window 1``)."""
    active = 1 if run.endswith("window") else layers
    return steps // PV_ARGS["code_update_every"] * projs * active


def pv_launch_formula(layers: int, steps: int, window: int | None = None, projs: int = 7) -> dict:
    """B13 and B14 launches of a ``cli.finetune`` run, from the code: the ST
    buffers' init dequantizes each ST-active projection once (B13); every
    gradient pass (steps x microbatches) dequantizes each ST-active
    projection once, outside the blocks' recompute (B13), and backpropagates
    it once (B14); with ``--st_window`` each inactive layer's projection runs
    its reference-mode matmul in the forward and again in the block's
    recompute (B13 twice) and backpropagates once (B14). The teacher is
    dense, the V step's beam search gathers codebook rows itself, and the
    saves dequantize nothing."""
    active = layers if window is None else window
    passes = steps * (PV_ARGS["batch_size"] // PV_ARGS["microbatch_size"])
    return {"dequantize_onehot": projs * active + passes * projs * (active + 2 * (layers - active)),
            "cb_grad_segment": passes * projs * layers}


def _heldout_kl(params, teacher, cfg, ids) -> float:
    """KL(teacher || student) over ``ids`` (the chunked loss of the CLI's path)."""
    from aqlm_tpu_torch.models import llama
    from aqlm_tpu_torch.pv.losses import chunked_kl_loss

    with torch.no_grad():
        s_hidden, _ = llama.forward(params, cfg, ids, return_hidden=True)
        t_hidden, _ = llama.forward(teacher, cfg, ids, return_hidden=True)
        return float(chunked_kl_loss(s_hidden, t_hidden, params["lm_head"].weight,
                                     teacher["lm_head"].weight))


class _VStepRecorder:
    """Wraps the V step's beam search: per call, the groups whose codes
    changed against ``ceil(max_update_fraction x groups)``, and
    ||W_q(new) - st||^2 against ||W_q(old) - st||^2 (W_q by gathering the
    codebook rows, as the search does; no kernel). The first ``keep`` calls
    after ``keep_codes(keep)`` also keep their new codes (on the host), in
    ``kept``."""

    def __init__(self, search):
        self.search, self.calls, self.check_s = search, [], 0.0
        self.kept, self.keep = [], 0

    def keep_codes(self, keep: int) -> list:
        self.kept, self.keep = [], keep
        return self.kept

    def __call__(self, reference_weight, codebooks, prev_codes, scales, **kw):
        new = self.search(reference_weight, codebooks, prev_codes, scales, **kw)
        t0 = time.perf_counter()
        if len(self.kept) < self.keep:
            self.kept.append(new.cpu())
        OG, IG, K = prev_codes.shape
        _, S, og, ig = codebooks.shape
        cb = codebooks.float().reshape(K, S, og * ig)
        ref = reference_weight.float()

        def err(codes):
            flat = codes.reshape(-1, K).long()
            groups = sum(cb[k][flat[:, k]] for k in range(K)).reshape(OG, IG, og, ig)
            w = (groups * scales.float().reshape(OG, -1)[:, :, None, None]).permute(0, 2, 1, 3)
            return float(((w.reshape(OG * og, IG * ig) - ref) ** 2).sum())

        before, after = err(prev_codes), err(new)
        changed = int((new != prev_codes).any(-1).sum())
        limit = math.ceil(kw["max_update_fraction"] * OG * IG)
        self.calls.append({"groups": OG * IG, "changed": changed, "limit": limit,
                           "err_before": before, "err_after": after,
                           "ok": changed <= limit and after <= before * (1 + 1e-5)})
        torch.cuda.synchronize()
        self.check_s += time.perf_counter() - t0
        return new


def _kernel_share(launches: dict) -> dict:
    """B13's and B14's device time over a run, as launches x their phase-2
    times at the path's shapes (q's for q/k/v/o, gate's for gate/up, down's
    B13 and gate's B14, whose group count down shares)."""
    ms = {(r["kernel"], r["proj"]): r["ms"] for r in RECORDS if r.get("phase") == "check"
          and r.get("kernel") in PATH_KERNELS["pv"] and r.get("precise") and not r.get("scales")}
    per_layer = {k: 4 * ms[(k, "q")] + 2 * ms[(k, "gate")] + ms[(k, "down" if (k, "down") in ms
                                                                     else "gate")]
                 for k in PATH_KERNELS["pv"]}
    return {k: launches[k] / 7 * per_layer[k] / 1e3 for k in PATH_KERNELS["pv"]}


def pv_run(dev, kept: dict) -> dict:
    """``aqlm_tpu_torch.cli.finetune.main`` in-process: the calibrated
    checkpoint (``CALIB_DIR``) as the student of random:llama2_7b:2, the
    dense seed-0 model the calibration quantized, full width, outside
    inference mode: ``PV_ARGS`` (8 steps of 2 x 2 x 512 ids, a V step every 2),
    saving to ``PV_DIR`` with the training state every 4 steps; then a 4-step
    run with ``--st_window 1 --offload_teacher`` from the same seed. Gates:
    every step's KL finite; on a held-out 2 x 512 batch the tuned student's
    KL below the calibrated one's; every V step within its change budget
    and not farther from its buffer; B13 and B14 exactly as
    ``pv_launch_formula`` says and no other kernel; the second run's KL
    within 1e-3 of the first run's first 4 steps; the saved checkpoint loaded
    by the port's loader with the final state's codes; one gradient pass at
    batch 1 x 128 on the card against the CPU's plain path (loss within 1e-2,
    each gradient within 3e-2 of its largest CPU magnitude). ``kept`` gets
    each run's codes from the V steps of its first ``PV_SCAN_STEPS`` steps
    (``pv_scan`` compares its codes with them)."""
    from aqlm_tpu_torch.cli import finetune as cf
    from aqlm_tpu_torch.cli.common import resolve_model
    from aqlm_tpu_torch.io import load_quantized_model
    from aqlm_tpu_torch.models import llama
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.pv import PVConfig, configurable_adamw, init_pv_state, make_pv_step
    from aqlm_tpu_torch.pv import straight_through as pst
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    layers, base = 2, "random:llama2_7b:2"
    argv = ["--base_model", base, "--quantized_model", CALIB_DIR]
    for k, v in PV_ARGS.items():
        argv += [f"--{k}", str(v)]
    teacher, cfg, _ = resolve_model(base, device=dev)
    heldout = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 512))).to(dev)
    calibrated, _ = load_quantized_model(CALIB_DIR, device=dev)
    kl_calibrated = _heldout_kl(calibrated, teacher, cfg, heldout)
    del calibrated

    saved = {}
    save = cf.save_quantized_model

    def capture(path, params, *a, **kw):  # the final state's codes, as the CLI saves them
        saved.update({(li, n): params["layers"][li][n].codes.cpu()
                      for li in range(layers) for n in llama.QUANTIZABLE_PROJS})
        return save(path, params, *a, **kw)

    recorder = _VStepRecorder(pst.beam_search_optimal_codes_l2)
    cf.save_quantized_model, pst.beam_search_optimal_codes_l2 = capture, recorder
    runs = {}
    try:
        for name, extra in (("pv", ["--save", PV_DIR, "--save_state_every", "4"]),
                            ("pv_window", ["--st_window", "1", "--offload_teacher"])):
            run_argv = argv + extra
            if name == "pv_window":
                run_argv[run_argv.index("--total_steps") + 1] = str(PV_WINDOW_STEPS)
            n_calls = len(recorder.calls)
            kept[name] = recorder.keep_codes(_v_calls(name, PV_SCAN_STEPS, layers))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = cf.main(run_argv)
            torch.cuda.synchronize()
            runs[name] = {"argv": run_argv, "total_s": time.perf_counter() - t0,
                          "launches": {k: v.launches for k, v in _build.KERNELS.items()},
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "losses": res["step_losses"], "seconds": res["seconds"],
                          "v_calls": recorder.calls[n_calls:]}
    finally:
        cf.save_quantized_model, pst.beam_search_optimal_codes_l2 = save, recorder.search

    tuned, _ = load_quantized_model(PV_DIR, device=dev)
    kl_tuned = _heldout_kl(tuned, teacher, cfg, heldout)
    codes_ok = len(saved) == 7 * layers and all(
        torch.equal(tuned["layers"][li][n].codes.cpu(), c) for (li, n), c in saved.items())
    del tuned

    # one gradient pass of the calibrated student, on the card and on the CPU
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 128)))
    cpu = torch.device("cpu")
    teacher_cpu = _to(teacher, cpu)
    grad_ref = []
    for d, t_params in ((dev, teacher), (cpu, teacher_cpu)):
        student, _ = load_quantized_model(CALIB_DIR, device=d)
        pv = PVConfig()
        state = init_pv_state(student, configurable_adamw(pv.lr), configurable_adamw(pv.code_lr))
        del student
        loss, grads = make_pv_step(cfg, cfg, pv).grad_fn(state, t_params, ids.to(d))
        grad_ref.append((float(loss), [g.float().cpu() for g in tree_leaves(grads)]))
        del state, grads
    del teacher, teacher_cpu
    torch.cuda.empty_cache()
    (loss, grads), (want_loss, want_grads) = grad_ref
    ratios = [float((g - w).abs().max() / w.abs().max()) if w.any() else
              (0.0 if not g.any() else float("inf")) for g, w in zip(grads, want_grads)]
    shutil.rmtree(PV_DIR)

    main_run, win = runs["pv"], runs["pv_window"]
    for name, r in runs.items():
        steps = len(r["losses"])
        want = pv_launch_formula(layers, steps, 1 if name == "pv_window" else None)
        r["launch_formula"] = want
        r["launches_match"] = all(r["launches"][k] == want[k] for k in PATH_KERNELS["pv"])
        r["no_other_kernel"] = all(n == 0 for k, n in r["launches"].items()
                                   if k not in PATH_KERNELS["pv"])
        r["losses_finite"] = bool(all(np.isfinite(r["losses"])))
        r["v_steps_ok"] = bool(r["v_calls"]) and all(c["ok"] for c in r["v_calls"])
        step_s = [a + b for a, b in zip(r["seconds"]["grad"], r["seconds"]["apply"])]
        share = _kernel_share(r["launches"])
        r["kernel_s"] = share
        r["kernel_share_of_steps"] = sum(share.values()) / (sum(step_s) + sum(r["seconds"]["code"]))
    kl_rel = [abs(a - b) / abs(b) for a, b in zip(win["losses"], main_run["losses"])]
    grad_ok = abs(loss - want_loss) <= 1e-2 * abs(want_loss) and all(r <= 3e-2 for r in ratios)
    ok = (all(r["launches_match"] and r["no_other_kernel"] and r["losses_finite"]
              and r["v_steps_ok"] for r in runs.values())
          and kl_tuned < kl_calibrated and max(kl_rel) <= 1e-3 and codes_ok and grad_ok)
    n_micro = PV_ARGS["batch_size"] // PV_ARGS["microbatch_size"]
    return {"phase": "pv", "model": "llama2_7b", "layers": layers, "hidden": cfg.hidden_size,
            "intermediate": cfg.intermediate_size, "student": CALIB_DIR, "teacher": base,
            "args": PV_ARGS, "microbatches": n_micro, "runs": runs,
            "s_per_step": {part: statistics.median(main_run["seconds"][part][1:] or
                                                   main_run["seconds"][part])
                           for part in ("grad", "apply", "code")},
            "v_check_s": recorder.check_s,
            "heldout_kl": {"calibrated": kl_calibrated, "tuned": kl_tuned,
                           "falls": kl_tuned < kl_calibrated},
            "window_kl_rel_err": kl_rel, "window_kl_ok": max(kl_rel) <= 1e-3,
            "saved_codes_equal_final": codes_ok,
            "grad_check": {"ids": [1, 128], "loss": loss, "cpu_loss": want_loss,
                           "max_grad_err_over_max": max(ratios), "leaves": len(ratios),
                           "tol": "loss 1e-2 relative; each grad max|cuda - cpu| <= 3e-2 max|cpu|",
                           "ok": grad_ok},
            "ok": bool(ok)}


# ---------------------------------------------------------------------------
# phase 5c: the scanned PV student (cli.finetune --scan_blocks) and its depth
# ---------------------------------------------------------------------------


def pv_scan_launch_formula(layers: int, steps: int, window: int | None = None,
                           projs: int = 7) -> dict:
    """B13 and B14 launches of a ``cli.finetune --scan_blocks`` run: the ST
    buffers' init dequantizes each ST-active projection once (B13); every
    gradient pass (steps x microbatches) runs each projection of each layer
    through ``_make_manual_st_proj``: B13 to W^T in the forward, B13 again
    in f32 and B14 in the backward, whatever the window. The windowed run's
    zeros window, the host Adam, the teacher and the V step launch
    nothing."""
    active = layers if window is None else window
    passes = steps * (PV_ARGS["batch_size"] // PV_ARGS["microbatch_size"])
    return {"dequantize_onehot": projs * active + passes * projs * 2 * layers,
            "cb_grad_segment": passes * projs * layers}


def pv_scan_run(dev, pv_rec: dict, pv_codes: dict) -> dict:
    """``cli.finetune --scan_blocks`` in-process, as ``pv_run`` runs the
    unrolled student: the calibrated checkpoint, ``PV_ARGS`` cut to
    ``PV_SCAN_STEPS`` steps, then the same with ``--st_window 1
    --offload_teacher`` (the windowed rotation: zeros window, bf16
    gradients down, bf16 buffers up). Gates: each step's KL within 1e-3
    (relative) of the same step of ``pv`` and ``pv_window``; every V step
    within its budget and not farther from its buffer; B13 and B14 exactly as
    ``pv_scan_launch_formula`` says, no other kernel; one scanned gradient
    pass of the calibrated student at 1 x 128 ids on the card (B13/B14)
    against the same pass on the CPU with the kernels' plain versions
    (``scan_dequant="kernel"``): loss within 1e-2, each gradient within 3e-2
    of its largest CPU magnitude. Recorded: the largest KL difference and
    the groups whose codes differ from the unrolled runs' after the same V
    steps."""
    from aqlm_tpu_torch.cli import finetune as cf
    from aqlm_tpu_torch.cli.common import resolve_model
    from aqlm_tpu_torch.io import load_quantized_model
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.pv import PVConfig, configurable_adamw, init_pv_state, make_pv_step
    from aqlm_tpu_torch.pv import straight_through as pst
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    layers, base = 2, "random:llama2_7b:2"
    argv = ["--base_model", base, "--quantized_model", CALIB_DIR, "--scan_blocks"]
    for k, v in dict(PV_ARGS, total_steps=PV_SCAN_STEPS).items():
        argv += [f"--{k}", str(v)]
    recorder = _VStepRecorder(pst.beam_search_optimal_codes_l2)
    pst.beam_search_optimal_codes_l2 = recorder
    runs = {}
    try:
        for name, ref, extra in (("pv_scan", "pv", []),
                                 ("pv_scan_window", "pv_window",
                                  ["--st_window", "1", "--offload_teacher"])):
            n_calls = len(recorder.calls)
            codes = recorder.keep_codes(_v_calls(name, PV_SCAN_STEPS, layers))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = cf.main(argv + extra)
            torch.cuda.synchronize()
            r = {"argv": argv + extra, "total_s": time.perf_counter() - t0,
                 "launches": {k: v.launches for k, v in _build.KERNELS.items()},
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "losses": res["step_losses"], "seconds": res["seconds"],
                 "v_calls": recorder.calls[n_calls:]}
            want = pv_scan_launch_formula(layers, len(r["losses"]),
                                          1 if name.endswith("window") else None)
            r["launch_formula"] = want
            r["launches_match"] = all(r["launches"][k] == want[k] for k in PATH_KERNELS[name])
            r["no_other_kernel"] = all(n == 0 for k, n in r["launches"].items()
                                       if k not in PATH_KERNELS[name])
            r["losses_finite"] = bool(all(np.isfinite(r["losses"])))
            r["v_steps_ok"] = bool(r["v_calls"]) and all(c["ok"] for c in r["v_calls"])
            ref_losses = pv_rec["runs"][ref]["losses"][:len(r["losses"])]
            r["kl_rel_err_vs_" + ref] = [abs(a - b) / abs(b) for a, b in
                                         zip(r["losses"], ref_losses)]
            r["kl_ok"] = len(ref_losses) == PV_SCAN_STEPS and max(r["kl_rel_err_vs_" + ref]) <= 1e-3
            pairs = list(zip(codes, pv_codes[ref]))
            r["codes_compared_calls"] = len(pairs)
            r["groups_with_other_codes"] = sum(int((a != b).any(-1).sum()) for a, b in pairs)
            r["groups_compared"] = sum(a.shape[0] * a.shape[1] for a, _ in pairs)
            step_s = [a + b for a, b in zip(r["seconds"]["grad"], r["seconds"]["apply"])]
            share = _kernel_share(r["launches"])
            r["kernel_s"] = share
            r["kernel_share_of_steps"] = sum(share.values()) / (sum(step_s) + sum(
                r["seconds"]["code"]))
            r["s_per_step"] = {part: statistics.median(r["seconds"][part][1:] or
                                                       r["seconds"][part])
                               for part in ("grad", "apply", "code")}
            runs[name] = r
            del codes, pairs
    finally:
        pst.beam_search_optimal_codes_l2 = recorder.search

    # one scanned gradient pass, on the card (B13/B14) and on the CPU (plain versions)
    teacher, cfg, _ = resolve_model(base, device=dev)
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 128)))
    cpu = torch.device("cpu")
    grad_ref = []
    for d, impl in ((dev, "auto"), (cpu, "kernel")):
        student, _ = load_quantized_model(CALIB_DIR, device=d)
        t_params = teacher if d == dev else _to(teacher, cpu)
        pv = PVConfig(scan_blocks=True, scan_dequant=impl)
        state = init_pv_state(student, configurable_adamw(pv.lr), configurable_adamw(pv.code_lr))
        del student
        loss, grads = make_pv_step(cfg, cfg, pv).grad_fn(state, t_params, ids.to(d))
        grad_ref.append((float(loss), [g.float().cpu() for g in tree_leaves(grads)]))
        del state, grads, t_params
    del teacher
    torch.cuda.empty_cache()
    (loss, grads), (want_loss, want_grads) = grad_ref
    ratios = [float((g - w).abs().max() / w.abs().max()) if w.any() else
              (0.0 if not g.any() else float("inf")) for g, w in zip(grads, want_grads)]
    grad_ok = abs(loss - want_loss) <= 1e-2 * abs(want_loss) and all(r <= 3e-2 for r in ratios)
    ok = all(r["launches_match"] and r["no_other_kernel"] and r["losses_finite"]
             and r["v_steps_ok"] and r["kl_ok"] for r in runs.values()) and grad_ok
    return {"phase": "pv_scan", "model": "llama2_7b", "layers": layers, "hidden": cfg.hidden_size,
            "intermediate": cfg.intermediate_size, "student": CALIB_DIR, "teacher": base,
            "steps": PV_SCAN_STEPS, "runs": runs,
            "grad_check": {"ids": [1, 128], "loss": loss, "cpu_loss": want_loss,
                           "max_grad_err_over_max": max(ratios), "leaves": len(ratios),
                           "cpu_dequant": "kernel (B13/B14's plain versions)",
                           "tol": "loss 1e-2 relative; each grad max|cuda - cpu| <= 3e-2 max|cpu|",
                           "ok": grad_ok},
            "ok": bool(ok)}


DEPTH_TOKENS = 512
DEPTH_PASSES = 3  # timed gradient passes a configuration (the median is kept)


def depth_launch_formula(layers: int, scanned: bool, window: int = 1, projs: int = 7) -> dict:
    """B13/B14 launches of one gradient pass of the depth probe: scanned,
    each projection B13 forward and backward and B14 backward; unrolled, the
    window's projections once outside the blocks' recompute and the others'
    twice (forward, recompute), each B14 once."""
    if scanned:
        return {"dequantize_onehot": 2 * projs * layers, "cb_grad_segment": projs * layers}
    return {"dequantize_onehot": projs * (window + 2 * (layers - window)),
            "cb_grad_segment": projs * layers}


def _depth_pass(params, cfg, scanned, teacher, ids, dev, passes):
    """``passes`` gradient passes of ``make_pv_step``'s ``grad_fn`` (scanned
    or unrolled) with a one-layer zeros ST window at layer 0: (seconds, loss,
    finite, the window's and the codebooks' gradients of the last pass)."""
    from aqlm_tpu_torch.models.llama import QUANTIZABLE_PROJS
    from aqlm_tpu_torch.pv import PVConfig, init_pv_state, make_pv_step
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    pv = PVConfig(chunk_tokens=256, scan_blocks=scanned)
    state = init_pv_state(params, lambda leaves: None, None, active_layers=())
    zeros = {name: torch.zeros((1, q.codes.shape[0], q.codes.shape[1] * 8), dtype=torch.float32,
                               device=dev)
             for name, q in ((n, params["layers"][0][n]) for n in QUANTIZABLE_PROJS)}
    state.st_buffers = zeros if scanned else [{k: v[0] for k, v in zeros.items()}] + [
        {} for _ in range(cfg.num_layers - 1)]
    grad_fn = make_pv_step(cfg, cfg, pv, teacher_kind="hidden").grad_fn
    args = (None, 0) if scanned else ()
    seconds, finite = [], True
    for _ in range(passes):
        t0 = time.perf_counter()
        loss, (g_tr, g_st) = grad_fn(state, teacher, ids, *args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves((g_tr, g_st)))
    window = g_st if scanned else {k: v[None] for k, v in g_st[0].items()}
    books = [{n: g_tr["layers"][li][n].codebooks.float() for n in QUANTIZABLE_PROJS}
             for li in range(cfg.num_layers)]
    return seconds, float(loss), finite, {k: v.float() for k, v in window.items()}, books


def _grad_gaps(a, b) -> dict:
    """Loss relative error and max|a - b| / max|b| over the window's and the
    codebooks' gradients of two ``_depth_pass`` results."""
    (_, la, _, wa, ca), (_, lb, _, wb, cb) = a, b
    return {"loss_rel_err": abs(la - lb) / abs(lb),
            "window_grad_err_over_max": max(float((wa[k] - wb[k]).abs().max()
                                                  / wb[k].abs().max()) for k in wb),
            "codebook_grad_err_over_max": max(float((x[n] - y[n]).abs().max() / y[n].abs().max())
                                              for x, y in zip(ca, cb) for n in y)}


def pv_scan_depth_run(dev) -> dict:
    """The scanned student's gradient pass at Llama-2-7B's full width: a
    random reference-mode 2x8 g8 student (``random_quantized_params``, seed
    11, bf16 embedding, norms and head), a one-layer zeros ST window at layer
    0, the teacher as hidden states [1, 512, 4096] and a dense head (seed
    12), the chunked KL at 256 tokens a chunk. In bf16, ``DEPTH_PASSES``
    passes of the scanned student ("manual", B13/B14) at 8 and 32 layers
    and of the unrolled one at 8: seconds (median, synchronised), peak
    memory, B13/B14 launches against ``depth_launch_formula``, finite loss
    and gradients. Then the 8-layer comparison, one pass each, in f32 (the
    same draw, its embedding, norms and head in f32 and its codebook entries
    rounded to bf16 once, so the manual projections' bf16 entries equal the
    unrolled path's f32 ones): the scanned loss within 1e-2 (relative) of
    the unrolled one's and its window and codebook gradients within 3e-2 of
    the unrolled gradient's largest magnitude. The random draw is chaotic
    (its attention is nearly an argmax), so in bf16 the two paths' roundings
    give gradients far apart (and both far from f32's,
    ``experiments/torch_pv_scan_precision.py``): that comparison is recorded,
    not gated."""
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.models.llama import ModelConfig
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.ops import _build

    full = ModelConfig.llama2_7b()
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(11), full,
                                     AqlmScheme.parse("2x8g8"), mode="reference", device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    teacher = {"hidden": torch.randn((1, DEPTH_TOKENS, full.hidden_size), generator=gen,
                                     device=dev).to(torch.bfloat16),
               "head": (torch.randn((full.vocab_size, full.hidden_size), generator=gen, device=dev)
                        * full.hidden_size ** -0.5).to(torch.bfloat16), "embed": None}
    ids = torch.randint(0, full.vocab_size, (1, DEPTH_TOKENS), generator=gen, device=dev)
    runs, kept = {}, {}
    for label, layers, scanned in (("scan_8", 8, True), ("scan_32", 32, True),
                                   ("unrolled_8", 8, False)):
        cfg = dataclasses.replace(full, num_layers=layers)
        p = dict(params, layers=params["layers"][:layers])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        out = _depth_pass(p, cfg, scanned, teacher, ids, dev, DEPTH_PASSES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        want = {k: DEPTH_PASSES * n for k, n in depth_launch_formula(layers, scanned).items()}
        if layers == 8:
            kept[label] = out
        runs[label] = {"layers": layers, "scanned": scanned, "dtype": "bfloat16", "loss": out[1],
                       "s_per_pass": statistics.median(out[0]), "seconds": out[0],
                       "peak_mem_gib": peak, "launches": launches, "launch_formula": want,
                       "launches_match": all(launches[k] == want[k]
                                             for k in PATH_KERNELS["pv_scan_depth"]),
                       "no_other_kernel": all(n == 0 for k, n in launches.items()
                                              if k not in PATH_KERNELS["pv_scan_depth"]),
                       "finite": out[2]}
        del out, p
        torch.cuda.empty_cache()
    bf16_gaps = _grad_gaps(kept.pop("scan_8"), kept.pop("unrolled_8"))

    # the 8-layer comparison in f32, the codebook entries on the bf16 grid
    cfg = dataclasses.replace(full, num_layers=8)
    p = _dense_to(dict(params, layers=params["layers"][:8]), torch.float32)
    for layer in p["layers"]:
        for name, q in list(layer.items()):
            if hasattr(q, "codebooks"):
                layer[name] = dataclasses.replace(
                    q, codebooks=q.codebooks.to(torch.bfloat16).float())
    teacher32 = {"hidden": teacher["hidden"].float(), "head": teacher["head"].float(),
                 "embed": None}
    del params, teacher
    f32_runs = {}
    for label, scanned in (("scan_8_f32", True), ("unrolled_8_f32", False)):
        _build.reset_launch_counts()
        f32_runs[label] = _depth_pass(p, cfg, scanned, teacher32, ids, dev, 1)
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        want = depth_launch_formula(8, scanned)
        runs[label] = {"layers": 8, "scanned": scanned, "dtype": "float32",
                       "loss": f32_runs[label][1], "seconds": f32_runs[label][0],
                       "launches": launches, "launch_formula": want,
                       "launches_match": all(launches[k] == want[k]
                                             for k in PATH_KERNELS["pv_scan_depth"]),
                       "no_other_kernel": all(n == 0 for k, n in launches.items()
                                              if k not in PATH_KERNELS["pv_scan_depth"]),
                       "finite": f32_runs[label][2]}
    gaps = _grad_gaps(f32_runs["scan_8_f32"], f32_runs["unrolled_8_f32"])
    del p, teacher32, f32_runs
    torch.cuda.empty_cache()
    cmp_ok = (gaps["loss_rel_err"] <= 1e-2 and gaps["window_grad_err_over_max"] <= 3e-2
              and gaps["codebook_grad_err_over_max"] <= 3e-2)
    ok = cmp_ok and all(r["launches_match"] and r["no_other_kernel"] and r["finite"]
                        for r in runs.values())
    # the phase's launches for the kernel line: the 32-layer passes' (its depth)
    return {"phase": "pv_scan_depth", "model": "llama2_7b", "tokens": DEPTH_TOKENS,
            "window": [0], "chunk_tokens": 256, "passes": DEPTH_PASSES, "runs": runs,
            "launches": runs["scan_32"]["launches"],
            "scan_vs_unrolled_8_f32": {**gaps, "tol": "loss 1e-2 relative; window and codebook "
                                       "grads max|scan - unrolled| <= 3e-2 max|unrolled|",
                                       "ok": cmp_ok},
            "scan_vs_unrolled_8_bf16": {**bf16_gaps, "gated": False},
            "ok": bool(ok)}


# ---------------------------------------------------------------------------
# phase 5d: the scheme converters (cli.convert --to requant|2x8|2x7), served
# ---------------------------------------------------------------------------

CONVERT_DIR = os.path.join("build", "converted")  # deleted at the end of the phase
for _run in ("convert_requant", "convert_2x8", "convert_2x7"):
    PATH_KERNELS[_run] = PATH_KERNELS["serve_calibrated"]


def serve_check(dev, path: str, run: str) -> dict:
    """A checkpoint loaded with the port's loader (bf16 dense parts),
    transcoded to codes mode (``convert_runtime_mode``) and served by
    ``Engine.generate`` (4 prompts, 16 new tokens, greedy): K1, K2 and K3
    launch and no other kernel. Its prefill logits (``llama.forward`` over 64
    tokens, K2) lie within 3e-2 max|logit| of the same checkpoint in
    reference mode on the card (B13's route)."""
    from aqlm_tpu_torch.io import load_quantized_model
    from aqlm_tpu_torch.models import llama
    from aqlm_tpu_torch.models.quantize import convert_runtime_mode
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.serve import Engine, SamplingParams, ServeConfig

    params, cfg = load_quantized_model(path, device=dev)
    params = _dense_to(params, torch.bfloat16)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 64))).to(dev)
    with torch.inference_mode():
        _build.reset_launch_counts()
        ref = llama.forward(params, cfg, ids)[0][0].float()
        ref_b13 = _build.KERNELS["dequantize_onehot"].launches
        codes = convert_runtime_mode(params, "codes")
        got = llama.forward(codes, cfg, ids)[0][0].float()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    engine = Engine(codes, cfg, ServeConfig(max_batch=4, max_len=512, kv_quantized=True))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (16, 40, 64, 100)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, SamplingParams(max_new_tokens=16))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    scheme = next(v.scheme.name for v in params["layers"][0].values() if hasattr(v, "scheme"))
    del engine, codes, params
    torch.cuda.empty_cache()
    tokens_ok = all(len(o) == 16 and all(0 <= t < cfg.vocab_size for t in o) for o in out)
    ran = all(launches[k] > 0 for k in PATH_KERNELS[run])
    others = all(n == 0 for k, n in launches.items() if k not in PATH_KERNELS[run])
    logits_ok = bool(torch.isfinite(got).all()) and err <= 3e-2 * scale
    return {"phase": run, "checkpoint": path, "scheme": scheme, "layers": cfg.num_layers,
            "prompts": [len(p) for p in prompts], "new_tokens": 16, "generate_s": gen_s,
            "launches": launches, "reference_b13_launches": ref_b13,
            "prefill_logits": {"tokens": 64, "max_abs_err": err, "max_rel_err": err / scale,
                               "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                               "tol": "max|codes - reference| <= 3e-2 * max|reference|"},
            "first_tokens": [o[:4] for o in out],
            "ok": tokens_ok and ran and others and logits_ok and ref_b13 > 0}


PATH_KERNELS["convert_spec"] = PATH_KERNELS["serve_calibrated"]


def spec_recipe(dev, target: str, draft: str) -> dict:
    """README's speculative recipe: ``cli.generate TARGET --mode codes
    --draft_model DRAFT --spec_k 4 --max_new_tokens 32`` (the calibrated
    checkpoint and its 1x8 requant). Both keep f32 embeddings and heads, and
    the codes kernels take bf16 activations, so each is first saved again
    with its dense parts in bf16 (``_dense_to``). Gates: 32 new tokens,
    acceptance in [0, 1], K1, K2 and K3 launched and nothing else; the
    acceptance recorded."""
    from aqlm_tpu_torch.io import load_quantized_model, save_quantized_model

    paths = []
    for src in (target, draft):
        params, cfg = load_quantized_model(src, device=dev)
        paths.append(src.rstrip("/") + "_bf16")
        save_quantized_model(paths[-1], _dense_to(params, torch.bfloat16), cfg)
        del params
    argv = [paths[0], "--mode", "codes", "--draft_model", paths[1], "--spec_k", "4",
            "--max_new_tokens", "32", "--device", dev.type]
    try:
        gen, rec = _generate_cli(argv, PATH_KERNELS["convert_spec"])
    finally:
        for path in paths:
            shutil.rmtree(path, ignore_errors=True)
    line = json.loads(rec["lines"][-1])
    rec.update(acceptance=line["acceptance"], stats=gen["stats"],
               ok=(line["new_tokens"] == 32 and 0.0 <= line["acceptance"] <= 1.0
                   and all(rec["launches"][k] > 0 for k in PATH_KERNELS["convert_spec"])
                   and all(n == 0 for k, n in rec["launches"].items()
                           if k not in PATH_KERNELS["convert_spec"])))
    return rec


def _config_of(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def convert_run(dev) -> dict:
    """The scheme converters of ``cli.convert`` on the card, each output
    served (``serve_check``): ``--to requant --scheme 1x8`` of the calibrated
    checkpoint (gate: each projection's weight rel-MSE finite and below its
    k-means init's, the worst in the config); a 2-layer Llama-2-7B in 1x16
    g8 (``codes_1x16``'s draw, seed 0, bf16 dense parts, its scales brought
    to a dense layer's weight scale) written by ``save_quantized_model``,
    then ``--to 2x8`` and ``--to 2x7`` (gate: the worst codebook rel-MSE
    finite and in the config). Seconds of each
    conversion; every serve check's gates."""
    from aqlm_tpu_torch.calib import requantize as rq
    from aqlm_tpu_torch.cli import convert as cc
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.io import save_quantized_model
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.ops.dequant import dequantize_weight

    os.makedirs(CONVERT_DIR, exist_ok=True)
    runs, conversions = {}, {}
    inits, fits = [], []
    init, requantize = rq.init_quantized_weight, rq.requantize_weight

    def init_rec(W, scheme, **kw):  # each projection's k-means init and its rel-MSE
        out = init(W, scheme, **kw)
        err = dequantize_weight(out, dtype=torch.float32) - W
        inits.append(float((err * err).sum() / (W * W).sum()))
        return out

    def fit_rec(*a, **kw):
        out = requantize(*a, **kw)
        fits.append(out[1])
        return out

    rq.init_quantized_weight, rq.requantize_weight = init_rec, fit_rec
    try:
        dst = os.path.join(CONVERT_DIR, "requant_1x8")
        t0 = time.perf_counter()
        cc.main([CALIB_DIR, dst, "--to", "requant", "--scheme", "1x8"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        rq.init_quantized_weight, rq.requantize_weight = init, requantize
    cfg_out = _config_of(dst)
    conversions["convert_requant"] = {
        "source": CALIB_DIR, "to": "requant 1x8", "seconds": seconds,
        "init_rel_mse": inits, "rel_mse": fits, "worst_rel_mse": cfg_out["worst_rel_mse"],
        "ok": len(fits) == 14 and all(np.isfinite(f) and f < i for f, i in zip(fits, inits))
        and cfg_out["requantized_to"] == "1x8" and cfg_out["worst_rel_mse"] == max(fits)}
    runs["convert_requant"] = serve_check(dev, dst, "convert_requant")
    runs["convert_spec"] = spec_recipe(dev, CALIB_DIR, dst)
    shutil.rmtree(dst)

    from aqlm_tpu_torch.models.llama import ModelConfig

    cfg2 = dataclasses.replace(ModelConfig.llama2_7b(), num_layers=2)
    src = os.path.join(CONVERT_DIR, "codes_1x16")
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg2,
                                     AqlmScheme.parse("1x16g8"), mode="reference", device=dev)
    # at a dense layer's weight scale (in_features^-0.5; the draw's entries have std
    # 0.354): at the draw's own scale the attention is nearly an argmax, and codes
    # mode's bf16 books then pick other keys than reference mode's f32 ones (logits
    # 26-36% of max apart at 2 layers on the card), so the gate would measure that
    for layer in params["layers"]:
        for q in layer.values():
            if hasattr(q, "scales") and q.codes is not None:
                q.scales.mul_((q.codes.shape[1] * 8) ** -0.5 / 0.354)
    save_quantized_model(src, params, cfg2)
    del params
    for to in ("2x8", "2x7"):
        dst = os.path.join(CONVERT_DIR, to)
        t0 = time.perf_counter()
        cc.main([src, dst, "--to", to])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cfg_out = _config_of(dst)
        worst = cfg_out["worst_rel_mse"]
        conversions[f"convert_{to}"] = {
            "source": "codes_1x16 draw, 2 layers", "to": to, "seconds": seconds,
            "worst_rel_mse": worst,
            "ok": cfg_out["transcoded_from"] == "1x16" and bool(np.isfinite(worst)) and worst > 0}
        runs[f"convert_{to}"] = serve_check(dev, dst, f"convert_{to}")
        shutil.rmtree(dst)
    shutil.rmtree(CONVERT_DIR)
    ok = all(c["ok"] for c in conversions.values()) and all(r["ok"] for r in runs.values())
    return {"phase": "convert", "conversions": conversions, "runs": runs, "ok": bool(ok)}


def _dense_to(params: dict, dtype) -> dict:
    """The embedding, norms and dense head in ``dtype`` (K2 takes bf16
    activations); quantized projections as they are."""
    from aqlm_tpu_torch.models.common import DenseLinear

    cast = lambda v: v.to(dtype) if isinstance(v, torch.Tensor) else (
        DenseLinear(v.weight.to(dtype), None if v.bias is None else v.bias.to(dtype))
        if isinstance(v, DenseLinear) else v)
    out = {k: cast(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cast(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def serve_calibrated(dev) -> dict:
    """The calibrated checkpoint through ``serve_check`` (B13/B14 of the
    calibration stay at 0 there), then deleted."""
    rec = serve_check(dev, CALIB_DIR, "serve_calibrated")
    shutil.rmtree(CALIB_DIR)
    return rec


# ---------------------------------------------------------------------------
# phase 7: LoRA training through frozen codes and int8 backbones
# ---------------------------------------------------------------------------

LORA_RUNS = {"lora_codes": "codes", "lora_int8": "int8"}
PATH_KERNELS["lora_codes"] = ("gather_prefill", "gather_dequant_wt")
PATH_KERNELS["lora_int8"] = ("int8_matmul", "int8_matmul_transposed")
LORA = dict(r=8, alpha=16.0, lr=3e-3, batch=2, seq=512, steps=6, ref_layers=2,
            ref_shape=(128, 2), ref_aside_shape=(2, 128))
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def lora_wrap(params, cfg, gen, b_std=0.0):
    """LoraLinear adapters on q/k/v/o of every layer (through
    ``map_quantized_linears``, as a user wraps serving layouts): r 8, alpha
    16, lora_a normal / sqrt(r) of the projection's true width
    (``projection_shapes``, not the padded ``in_features``), lora_b zeros
    (or normal * ``b_std``), from ``gen`` on the params' device."""
    from aqlm_tpu_torch.models.common import LoraLinear
    from aqlm_tpu_torch.models.llama import projection_shapes
    from aqlm_tpu_torch.models.quantize import map_quantized_linears

    shapes, r = projection_shapes(cfg), LORA["r"]

    def wrap(li, name, q):
        if name not in LORA_TARGETS:
            return q
        d = q.scales.device
        a = torch.randn((r, shapes[name][1]), generator=gen, device=d) / r ** 0.5
        b = torch.randn((q.out_features, r), generator=gen, device=d) * b_std
        return LoraLinear(base=q, lora_a=a, lora_b=b, scale=LORA["alpha"] / r)

    return map_quantized_linears(params, wrap)


def lora_launch_formula(layers: int) -> dict:
    """Launches of one step over ``layers`` layers: every projection's forward
    (K2 or the int8 kernel: B * T > 8 rows) once, and its backward (B5 or B10)
    once, but for layer 0's q, k and v, whose input (the normed embedding,
    frozen) needs no gradient, so autograd never calls their backward."""
    return {"forward": 7 * layers, "backward": 7 * layers - 3}


def lora_reference(dev, mode) -> dict:
    """One make_lora_step on a 2-layer full-width Llama-2-7B, kernels on the
    card against the plain versions on the CPU, from the same params (built
    on the CPU from seed 2; lora_b normal * 0.01, so the adapters have a
    gradient at the first step). Gated on 128 x 2 ids: only position 0
    enters the loss and its attention has one key, so the gradients are
    well conditioned (the CPU alone, bf16 against f32 activations: within
    2.4% of max|grad|; ``experiments/torch_lora_grad_sensitivity.py``). The
    loss within 1e-2 of the CPU's, each adapter's gradient within 3e-2 of its
    largest CPU magnitude (bf16 activations rounded at other points, as the
    logits bound), q/k's exactly zero on both, and the card's launches as
    ``lora_launch_formula``. On 2 x 128 ids the same comparison is reported
    ungated: random weights make attention near one-hot, and a near tie
    flips with one rounding (the CPU alone: 0.5-1.4 of max|grad|)."""
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.models.llama import ModelConfig
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.pv import init_lora_state, make_lora_step
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    layers = LORA["ref_layers"]
    cfg = dataclasses.replace(ModelConfig.llama2_7b(), num_layers=layers)
    cpu = torch.device("cpu")
    params = random_quantized_params(torch.Generator().manual_seed(2), cfg,
                                     AqlmScheme.parse("2x8g8"), mode=mode, device=cpu)
    params = lora_wrap(params, cfg, torch.Generator().manual_seed(3), b_std=0.01)
    res = {}
    for key, shape in (("gated", LORA["ref_shape"]), ("aside", LORA["ref_aside_shape"])):
        ids = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, shape))
        out = []
        for d in (dev, cpu):
            state = init_lora_state(_to(params, d), lambda p: torch.optim.Adam(p, lr=LORA["lr"]))
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            state, loss = make_lora_step(cfg)(state, ids.to(d))
            out.append((float(loss), [t.grad.float().cpu() for t in tree_leaves(state.adapters)],
                        {k: v.launches for k, v in _build.KERNELS.items() if v.launches},
                        time.perf_counter() - t0))
            del state
        (loss, grads, launches, card_s), (want_loss, want_grads, _, cpu_s) = out
        ratios = [float((g - w).abs().max() / w.abs().max()) if w.any() else
                  (0.0 if not g.any() else float("inf")) for g, w in zip(grads, want_grads)]
        res[key] = {"ids": list(shape), "loss": loss, "cpu_loss": want_loss,
                    "max_grad_err_over_max": max(ratios), "grad_err_over_max": ratios,
                    "launches": launches, "card_step_s": card_s, "cpu_step_s": cpu_s}
    g = res["gated"]
    f = lora_launch_formula(layers)
    fwd, bwd = PATH_KERNELS[f"lora_{mode}"]
    counts_ok = g["launches"] == {fwd: f["forward"], bwd: f["backward"]}
    loss_ok = np.isfinite(g["loss"]) and abs(g["loss"] - g["cpu_loss"]) <= 1e-2 * abs(g["cpu_loss"])
    grads_ok = all(r <= 3e-2 for r in g["grad_err_over_max"])
    return {"phase": "lora_reference", "mode": mode, "layers": layers, "hidden": 4096,
            "adapters": len(g["grad_err_over_max"]), **g, "launch_formula": f,
            "tol": "loss 1e-2 relative; each adapter grad max|cuda - cpu| <= 3e-2 max|cpu| "
                   "(zero where the CPU's is zero)", "attention_aside": res["aside"],
            "ok": bool(loss_ok and grads_ok and counts_ok)}


def profile_lora_step(step, state, ids) -> dict:
    """Device time by kernel over one more training step, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall_ms, "device_ms": total_ms, "device_busy_share": total_ms / wall_ms,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "calls": e.count} for e in top]}


def lora_run(dev, run) -> dict:
    """``make_lora_step`` at full Llama-2-7B width and depth, random weights
    from seed 0: ``steps`` Adam steps on one fixed batch of 2 x 512 random
    ids, adapters on q/k/v/o (``lora_wrap``), outside inference mode. Gates:
    finite losses, the last below the first; every adapter moved; every
    frozen tensor bit-unchanged; launches exactly ``steps`` times
    ``lora_launch_formula`` and no other kernel (no K1, K3 or B15)."""
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.models.llama import ModelConfig
    from aqlm_tpu_torch.models.quantize import random_quantized_params
    from aqlm_tpu_torch.ops import _build
    from aqlm_tpu_torch.pv import init_lora_state, make_lora_step
    from aqlm_tpu_torch.pv.trainer import tree_leaves

    mode, steps = LORA_RUNS[run], LORA["steps"]
    cfg = ModelConfig.llama2_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                     AqlmScheme.parse("2x8g8"), mode=mode, device=dev)
    params = lora_wrap(params, cfg, torch.Generator(device=dev).manual_seed(1))
    state = init_lora_state(params, lambda p: torch.optim.Adam(p, lr=LORA["lr"]))
    del params
    adapters0 = [t.detach().clone() for t in tree_leaves(state.adapters)]
    frozen0 = [t.clone() for t in tree_leaves(state.frozen)]
    step = make_lora_step(cfg)
    ids = torch.randint(0, cfg.vocab_size, (LORA["batch"], LORA["seq"]),
                        generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    _build.reset_launch_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, loss = step(state, ids)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - s0)
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    f = lora_launch_formula(cfg.num_layers)
    fwd, bwd = PATH_KERNELS[run]
    counts_ok = (launches[fwd] == steps * f["forward"] and launches[bwd] == steps * f["backward"]
                 and all(n == 0 for k, n in launches.items() if k not in (fwd, bwd)))
    finite = all(np.isfinite(losses))
    falls = finite and losses[-1] < losses[0]
    moved = all(not torch.equal(a, b.detach()) for a, b in zip(adapters0, tree_leaves(state.adapters)))
    frozen_ok = all(torch.equal(a, b) for a, b in zip(frozen0, tree_leaves(state.frozen)))
    del adapters0, frozen0
    prof = profile_lora_step(step, state, ids)
    tokens = LORA["batch"] * LORA["seq"]
    steady = statistics.median(step_s[1:])
    rec = {"phase": "lora", "run": run, "model": "llama2_7b", "mode": mode, "scheme": "2x8g8",
           "layers": cfg.num_layers, "hidden": cfg.hidden_size, "head": "dense bf16",
           "targets": list(LORA_TARGETS), **{k: LORA[k] for k in ("r", "alpha", "lr", "batch", "seq", "steps")},
           "optimizer": "torch.optim.Adam", "build_s": build_s, "step_s": step_s,
           "s_per_step": steady, "trained_tok_s": tokens / steady, "peak_mem_gib": peak_gib,
           "losses": losses, "launches": launches,
           "launches_per_step": {fwd: launches[fwd] / steps, bwd: launches[bwd] / steps},
           "launch_formula_per_step": f, "losses_finite": finite, "loss_falls": falls,
           "adapters_moved": moved, "frozen_unchanged": frozen_ok, "launches_match": counts_ok,
           "profile": prof, "ok": bool(falls and moved and frozen_ok and counts_ok)}
    del state, step
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 8: the entry points a user calls, on one canonical Llama-2-7B checkpoint
# ---------------------------------------------------------------------------

ENTRY_SEED = 5
ENTRY_LAYERS = 8  # the canonical checkpoint's depth (full width)
ENTRY_PROJS = 7  # quantized projections a layer; the dense bf16 head is no kernel's
EVAL_WINDOWS = 4  # 4096-id windows a mode: few, to keep the run inside its limit
EVAL_ARGS = ["--datasets", "random", "--nsamples", str(EVAL_WINDOWS), "--model_seqlen", "4096",
             "--batch_size", "1"]
EVAL_CPU_ARGS = ["--datasets", "random", "--nsamples", "1", "--model_seqlen", "256",
                 "--batch_size", "1"]  # the 2-layer card-against-CPU comparison
# evaluate runs: (mode, checkpoint) -> the kernel whose unindexed form each projection launches
EVAL_RUNS = (("codes", "canonical", "gather_prefill"), ("int8", "int8", "int8_matmul"),
             ("int4", "canonical", "int4_matmul"), ("reference", "canonical", "dequantize_onehot"))
PATH_KERNELS["unstacked_decode"] = ("lut_gemv", "gather_prefill")
for _mode, _, _kernel in EVAL_RUNS:
    PATH_KERNELS[f"evaluate_{_mode}"] = (_kernel,)
PATH_KERNELS["evaluate_int4"] += ("dequantize_onehot",)  # the int4 transcode at load
PATH_KERNELS["cli_serve"] = ("int8_matmul", "flash_decode_write")
PATH_KERNELS["cli_generate"] = ("lut_gemv", "gather_prefill", "flash_decode_write")
SERVE_LENGTHS = [64, 200, 700, 1100, 1500, 333, 90, 512]  # prompt ids a request
SERVE_STREAMED, SERVE_LOGPROBS = (2, 5), (3, 6)
SERVE_NEW = 64


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _launch_record() -> dict:
    from aqlm_tpu_torch.ops import _build

    return {"launches": {k: v.launches for k, v in _build.KERNELS.items()},
            "forms": {k: dict(v.forms) for k, v in _build.KERNELS.items() if v.forms}}


def _only_launched(rec: dict, want: dict) -> bool:
    """Exactly ``want`` {kernel: launches} by the unindexed form, every other
    kernel and form 0."""
    launches, forms = rec["launches"], rec["forms"]
    return (all(launches[k] == n for k, n in want.items())
            and all(n == 0 for k, n in launches.items() if k not in want)
            and all(forms.get(k, {"unindexed": n}) == {"unindexed": n} for k, n in want.items()))


def entry_config():
    return dataclasses.replace(model_config("llama2_7b"), num_layers=ENTRY_LAYERS)


def write_entry_checkpoints(dev, root) -> dict:
    """Under ``root``: ``canonical``, Llama-2-7B in 2x8 g8 at full width and
    ENTRY_LAYERS layers (random codes, codebooks and scales from ENTRY_SEED; a bf16
    embedding, norms and head, so the kernels get bf16 activations), written
    by the port's ``save_quantized_model``; ``int8``, its ``cli.convert --to
    int8``; and the same model cut to 2 layers, canonical and converted to
    int8 and int4 (``canonical_2``, ``int8_2``, ``int4_2``)."""
    from aqlm_tpu_torch.cli import convert as cli_convert
    from aqlm_tpu_torch.config import AqlmScheme
    from aqlm_tpu_torch.io import save_quantized_model
    from aqlm_tpu_torch.models.quantize import random_quantized_params

    cfg = entry_config()
    paths = {k: os.path.join(root, k) for k in ("canonical", "int8", "canonical_2", "int8_2",
                                                 "int4_2")}
    seconds = {}
    t0 = time.perf_counter()
    params = random_quantized_params(torch.Generator(device=dev).manual_seed(ENTRY_SEED), cfg,
                                     AqlmScheme.parse("2x8g8"), mode="reference", device=dev)
    save_quantized_model(paths["canonical"], params, cfg)
    save_quantized_model(paths["canonical_2"], {**params, "layers": params["layers"][:2]},
                         dataclasses.replace(cfg, num_layers=2))
    del params
    torch.cuda.empty_cache()
    seconds["write_canonical"] = time.perf_counter() - t0
    for src, dst, to in (("canonical", "int8", "int8"), ("canonical_2", "int8_2", "int8"),
                         ("canonical_2", "int4_2", "int4")):
        t0 = time.perf_counter()
        cli_convert.main([paths[src], paths[dst], "--to", to, "--device", dev.type])
        torch.cuda.empty_cache()
        seconds[f"convert_{dst}"] = time.perf_counter() - t0
    size = lambda p: sum(os.path.getsize(os.path.join(p, f)) for f in os.listdir(p))
    return {"paths": paths, "seconds": seconds,
            "gib": {k: size(p) / 2 ** 30 for k, p in paths.items()}}


DECODE_B, DECODE_T0, DECODE_STEPS = 4, 64, 8  # unstacked_decode's batch, prefill, steps


def _unstacked_steps(params, cfg, ids, dev):
    """A DECODE_T0-token prefill into ``llama.init_kv_cache`` and
    DECODE_STEPS cached single-token steps of ``llama.forward``: (the last
    step's logits, prefill ms, each step's ms)."""
    from aqlm_tpu_torch.models import llama

    cache = llama.init_kv_cache(cfg, DECODE_B, DECODE_T0 + DECODE_STEPS, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    _, cache = llama.forward(params, cfg, ids[:, :DECODE_T0], kv_caches=cache, cache_offset=0)
    _sync(dev)
    prefill_ms, step_ms = (time.perf_counter() - t0) * 1e3, []
    for p in range(DECODE_T0, DECODE_T0 + DECODE_STEPS):
        t0 = time.perf_counter()
        out, cache = llama.forward(params, cfg, ids[:, p:p + 1], kv_caches=cache, cache_offset=p)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return out[:, -1].float().cpu(), prefill_ms, step_ms


def _stacked_steps(params, cfg, ids, dev, fuse):
    """The same steps through ``forward_stacked`` (the Engine's form: layers
    stacked, the kernels layer-indexed, q/k/v and gate/up fused or not) over
    a bf16 cache of DECODE_T0 + DECODE_STEPS rows (the plain attention, as
    the unstacked forward's): the last step's logits."""
    from aqlm_tpu_torch.models import stacked
    from aqlm_tpu_torch.serve import ServeConfig
    from aqlm_tpu_torch.serve.engine import serving_params

    max_len = DECODE_T0 + DECODE_STEPS
    st = serving_params(params, cfg, ServeConfig(max_batch=DECODE_B, max_len=max_len,
                                                 fuse_projections=fuse))
    cache = stacked.init_kv_cache(cfg, DECODE_B, max_len, quantized=False, device=dev)
    stacked.forward_stacked(st, cfg, ids[:, :DECODE_T0], cache=cache, cache_offset=0)
    for p in range(DECODE_T0, DECODE_T0 + DECODE_STEPS):
        out, _ = stacked.forward_stacked(st, cfg, ids[:, p:p + 1], cache=cache, cache_offset=p)
    return out[:, -1].float().cpu()


def _logit_diff(got, want) -> dict:
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return {"max_abs_err": err, "max_rel_err": err / scale,
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float().mean())}


def unstacked_decode(dev, paths) -> dict:
    """``llama.forward`` in codes mode over the canonical checkpoint (loaded
    and transcoded by ``cli.common.resolve_model``) at batch 4: a 64-token
    prefill into ``llama.init_kv_cache`` (K2's unindexed form), then 8 cached
    single-token steps (K1's tiled form). Gates: K2 launches exactly 7 x
    layers and K1 exactly 8 x 7 x layers times, by their unindexed forms, and nothing
    else launches; the last logits finite; and at 2 layers (the 2-layer
    cut), the last logits within 3e-2 max|logit| of ``forward_stacked``
    (fused, as the Engine runs it) over the same ids, as the reference
    phase gates at 2 layers. At ENTRY_LAYERS the same comparison, and the
    Engine's own fused form against its unfused one, are recorded ungated:
    the random model's attention logits have a std of ~540
    (experiments/torch_random_model_scale.py), so its softmax is nearly an
    argmax and routes that round differently drift apart with depth
    (experiments/torch_unstacked_depth.py)."""
    from aqlm_tpu_torch.cli.common import resolve_model
    from aqlm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    params, cfg, _ = resolve_model(paths["canonical"], mode="codes", device=dev)
    load_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_T0 + DECODE_STEPS))).to(dev)
    with torch.inference_mode():
        _build.reset_launch_counts()
        got, prefill_ms, step_ms = _unstacked_steps(params, cfg, ids, dev)
        rec = _launch_record()
        fused = _stacked_steps(params, cfg, ids, dev, True)
        unfused = _stacked_steps(params, cfg, ids, dev, False)
        full = {"vs_forward_stacked_fused": _logit_diff(got, fused),
                "vs_forward_stacked_unfused": _logit_diff(got, unfused),
                "stacked_fused_vs_unfused": _logit_diff(fused, unfused)}
        del params
        torch.cuda.empty_cache()
        p2, cfg2, _ = resolve_model(paths["canonical_2"], mode="codes", device=dev)
        got2 = _unstacked_steps(p2, cfg2, ids, dev)[0]
        two = _logit_diff(got2, _stacked_steps(p2, cfg2, ids, dev, True))
        del p2
    torch.cuda.empty_cache()
    per_forward = cfg.num_layers * ENTRY_PROJS
    formula = {"gather_prefill": per_forward, "lut_gemv": DECODE_STEPS * per_forward}
    counts_ok = _only_launched(rec, formula)
    two_ok = bool(torch.isfinite(got2).all()) and two["max_rel_err"] <= 3e-2
    return {"phase": "unstacked_decode", "mode": "codes", "layers": cfg.num_layers,
            "batch": DECODE_B, "prefill_tokens": DECODE_T0, "decode_steps": DECODE_STEPS,
            "kv": "bf16", "load_s": load_s, "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "decode_tok_s": DECODE_B * DECODE_STEPS / (sum(step_ms) / 1e3), **rec,
            "launch_formula": formula, "launches_match": counts_ok,
            "two_layers_vs_forward_stacked": {**two, "ok": two_ok,
                                              "tol": "max|unstacked - stacked| <= 3e-2 * max|stacked|"},
            "full_depth_ungated": full,
            "ok": counts_ok and bool(torch.isfinite(got).all()) and two_ok}


def _timed_eval(argv, dev) -> tuple[dict, float]:
    """(``cli.evaluate.main(argv)``'s result, seconds inside its
    ``evaluate_perplexity``): the CLI module's name is wrapped for the call."""
    from aqlm_tpu_torch.cli import evaluate as cli_evaluate

    inner, spent = cli_evaluate.evaluate_perplexity, []

    def timed(*args, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        _sync(dev)
        spent.append(time.perf_counter() - t0)
        return out

    cli_evaluate.evaluate_perplexity = timed
    try:
        res = cli_evaluate.main(argv)
    finally:
        cli_evaluate.evaluate_perplexity = inner
    return res, sum(spent)


def evaluate_run(dev, paths) -> dict:
    """``cli.evaluate.main`` in-process on 4 random windows of 4096 ids, batch
    1: in codes mode (the canonical checkpoint transcoded at load), on the
    materialized int8 checkpoint, in int4 (transcoded at load) and in
    reference mode. Gates: every perplexity finite; |ln PPL(codes) - ln
    PPL(reference)| <= 1e-2; each mode's kernel launched by its unindexed
    form exactly 4 windows x layers x 7 projections times (reference mode:
    B13, one dequant a projection a forward; int4 also B13 once a projection
    at load) and nothing else; and at 2
    layers (1 window of 256 ids), each mode's ln PPL on the card within
    1e-2 of the same CLI's on the CPU (plain versions), over the same
    checkpoints (int8 and int4 materialized)."""
    from aqlm_tpu_torch.ops import _build

    cfg = entry_config()
    nwin, seqlen = EVAL_WINDOWS, 4096
    runs = {}
    for mode, ckpt, kernel in EVAL_RUNS:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res, eval_s = _timed_eval([paths[ckpt], *EVAL_ARGS, "--mode", mode, "--device", dev.type],
                                  dev)
        _sync(dev)
        total_s = time.perf_counter() - t0
        rec = _launch_record()
        formula = {kernel: nwin * cfg.num_layers * ENTRY_PROJS}
        if mode == "int4":  # transcoded at load: B13 dequantizes each projection once
            formula["dequantize_onehot"] = cfg.num_layers * ENTRY_PROJS
        ppl = res["ppl_random"]
        runs[mode] = {"checkpoint": ckpt, "ppl": ppl, "ln_ppl": math.log(ppl),
                      "seconds": total_s, "load_s": total_s - eval_s, "eval_s": eval_s,
                      "s_per_window": eval_s / nwin, "tok_s": nwin * seqlen / eval_s, **rec,
                      "launch_formula": formula, "launches_match": _only_launched(rec, formula),
                      "finite": math.isfinite(ppl)}
        torch.cuda.empty_cache()
    small = {}
    for mode, ckpt, _ in EVAL_RUNS:
        path = paths[f"{ckpt}_2" if mode != "int4" else "int4_2"]
        lp = {}
        for d in (dev.type, "cpu"):
            t0 = time.perf_counter()
            res = _timed_eval([path, *EVAL_CPU_ARGS, "--mode", mode, "--device", d],
                              torch.device(d))[0]
            lp[d] = (math.log(res["ppl_random"]), time.perf_counter() - t0)
        card, cpu = lp[dev.type], lp["cpu"]
        small[mode] = {"checkpoint": os.path.basename(path), "ln_ppl_card": card[0],
                       "ln_ppl_cpu": cpu[0], "diff": abs(card[0] - cpu[0]),
                       "seconds_card": card[1], "seconds_cpu": cpu[1],
                       "ok": abs(card[0] - cpu[0]) <= 1e-2}
    codes_vs_ref = abs(runs["codes"]["ln_ppl"] - runs["reference"]["ln_ppl"])
    ok = (all(r["finite"] and r["launches_match"] for r in runs.values())
          and codes_vs_ref <= 1e-2 and all(s["ok"] for s in small.values()))
    return {"phase": "evaluate", "argv": EVAL_ARGS, "layers": cfg.num_layers, "windows": nwin,
            "seqlen": seqlen, "runs": runs, "ln_ppl_codes_vs_reference": codes_vs_ref,
            "two_layers_card_vs_cpu": {"argv": EVAL_CPU_ARGS, **small},
            "tol": "|ln PPL(codes) - ln PPL(reference)| <= 1e-2; 2 layers: |card - cpu| <= 1e-2",
            "ok": ok}


def _tensor_leaves(node):
    """Every tensor of a params tree (dicts, lists, weight dataclasses), in order."""
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _tensor_leaves(node[k])
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensor_leaves(v)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _tensor_leaves(getattr(node, f.name))


class _RecordingEngine:
    """The server's engine with its loop's ``submit`` and ``step`` calls
    recorded in order, so another engine can replay them."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def submit(self, prompt, sampling):
        rid = self.engine.submit(prompt, sampling)
        self.calls.append(("submit", prompt, sampling, rid))
        return rid

    def step(self):
        self.calls.append(("step",))
        return self.engine.step()

    def __getattr__(self, name):
        return getattr(self.engine, name)


def _completion(port, i, prompt, out):
    """One /v1/completions request (streamed, with logprobs or plain):
    out[i] = (its answer, seconds to the last byte, seconds to the first
    streamed chunk or None)."""
    import urllib.request

    body = {"prompt_ids": [int(t) for t in prompt], "max_tokens": SERVE_NEW,
            "temperature": 0.0}
    stream = i in SERVE_STREAMED
    if stream:
        body["stream"] = True
    if i in SERVE_LOGPROBS:
        body["logprobs"] = 1
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    # a proxy set in the environment must not take requests to 127.0.0.1
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=180) as r:
        if not stream:
            ans = json.loads(r.read())
        else:
            tokens = []
            for line in r:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    first = first or time.perf_counter() - t0
                    tokens += json.loads(line[len("data: "):])["choices"][0]["token_ids"]
            ans = {"choices": [{"token_ids": tokens}]}
    out[i] = (ans, time.perf_counter() - t0, first)


def _serve_requests(argv, prompts) -> dict:
    """``cli.serve`` built from ``argv`` in-process and served on a thread:
    ``prompts`` as concurrent /v1/completions requests (``_completion``),
    every launch count read over them. Returns the answers, the launches,
    the server loop's recorded engine calls, the served engine and the
    seconds."""
    import threading

    from aqlm_tpu_torch.cli import serve as cli_serve
    from aqlm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    httpd, server = cli_serve.make_server(cli_serve.build_parser().parse_args(argv))
    load_s = time.perf_counter() - t0
    recorder = server.engine = _RecordingEngine(server.engine)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    answers = {}
    try:
        _build.reset_launch_counts()
        clients = [threading.Thread(target=_completion, args=(port, i, p, answers))
                   for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(240)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        rec = _launch_record()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    return {"answers": answers, "launch_rec": rec, "calls": recorder.calls,
            "engine": recorder.engine, "load_s": load_s, "wall_s": wall_s}


def _replay(engine, served_engine, calls, prompts, answers) -> dict:
    """The server loop's engine calls replayed on ``engine`` (built on the
    same params): whether its serving tensors equal the served engine's bit
    for bit, the requests whose tokens differ, and the largest logprob
    difference of the requests that asked for them."""
    pairs = [(engine.params, served_engine.params)]
    if getattr(engine, "_spec", False):
        pairs.append((engine._dparams, served_engine._dparams))
    same = True
    for a, b in pairs:
        mine, theirs = list(_tensor_leaves(a)), list(_tensor_leaves(b))
        same = same and len(mine) == len(theirs) and all(torch.equal(x, y)
                                                         for x, y in zip(mine, theirs))
    del served_engine, pairs
    torch.cuda.empty_cache()
    rid_of = {}
    for call in calls:
        if call[0] == "submit":
            rid = engine.submit(call[1], call[2])
            rid_of[tuple(int(t) for t in call[1])] = rid
            assert rid == call[3]
        else:
            engine.step()
    mismatch, lp_err = [], 0.0
    for i, p in enumerate(prompts):
        if i not in answers:
            continue
        req = engine.requests[rid_of[tuple(int(t) for t in p)]]
        choice = answers[i][0]["choices"][0]
        if choice["token_ids"] != [int(t) for t in req.generated] or len(req.generated) != SERVE_NEW:
            mismatch.append(i)
        if i in SERVE_LOGPROBS:
            got = choice["logprobs"]["token_logprobs"]
            lp_err = max(lp_err, max(abs(a - b) for a, b in zip(got, req.logprobs)))
    return {"replay_params_identical": same, "replay_mismatch": mismatch,
            "logprob_max_abs_err": lp_err}


def _serve_record(argv, prompts, served, replay, replay_load_s, path_kernels) -> dict:
    answers, rec, calls = served["answers"], served["launch_rec"], served["calls"]
    lat = [answers[i][1] for i in sorted(answers)]
    ttft = [answers[i][2] for i in SERVE_STREAMED if i in answers]
    wall_s = served["wall_s"]
    ran = all(rec["launches"][k] > 0 for k in path_kernels)
    others = all(n == 0 for k, n in rec["launches"].items() if k not in path_kernels)
    out = {"argv": argv, "prompt_lengths": [len(p) for p in prompts], "new_tokens": SERVE_NEW,
           "streamed": [i for i in SERVE_STREAMED if i < len(prompts)],
           "logprobs": [i for i in SERVE_LOGPROBS if i < len(prompts)],
           "load_s": served["load_s"], "wall_s": wall_s, "requests_per_s": len(lat) / wall_s,
           "tokens_per_s": len(lat) * SERVE_NEW / wall_s,
           "latency_mean_s": statistics.mean(lat),
           "latency_p99_s": float(np.percentile(lat, 99)), "ttft_s": ttft,
           "engine_calls": {"submits": sum(c[0] == "submit" for c in calls),
                            "steps": sum(c[0] == "step" for c in calls)},
           **rec, **replay, "replay_load_s": replay_load_s,
           "tol": "tokens identical to the replaying Engine; logprobs within 1e-5"}
    out["ok"] = (sorted(answers) == list(range(len(prompts))) and replay["replay_params_identical"]
                 and not replay["replay_mismatch"] and replay["logprob_max_abs_err"] <= 1e-5
                 and ran and others)
    return out


def _generate_cli(argv, path_kernels) -> dict:
    """``cli.generate`` with ``argv``: its printed lines kept, its return and
    the launches over it; gates: the benchmark line and the JSON line as
    last, only ``path_kernels`` launched."""
    import contextlib
    import io

    from aqlm_tpu_torch.cli import generate as cli_generate
    from aqlm_tpu_torch.ops import _build

    _build.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        gen = cli_generate.main(argv)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    grec = _launch_record()
    ok = (("--benchmark" not in argv or lines[0].endswith(" tokens per second>"))
          and all(grec["launches"][k] > 0 for k in path_kernels)
          and all(n == 0 for k, n in grec["launches"].items() if k not in path_kernels))
    torch.cuda.empty_cache()
    return gen, {"argv": argv, "lines": lines, "seconds": seconds, **grec, "ok": ok}


SERVE_SPEC_REQUESTS = 4  # the speculative server answers the first 4 of the 8 requests
PATH_KERNELS["cli_serve_spec"] = ("int8_matmul", "lut_gemv", "gather_prefill",
                                  "flash_decode_write")
PATH_KERNELS["cli_generate_spec"] = PATH_KERNELS["cli_serve_spec"]


def cli_serve_run(dev, paths) -> dict:
    """``cli.serve`` over the materialized int8 checkpoint (``--max_batch 4
    --kv_int8 --decode_chunk 8``, 127.0.0.1, port 0), in-process: 8
    concurrent /v1/completions requests of 64-1500 prompt ids, 64 greedy new
    tokens each, 2 streamed (SSE) and 2 with logprobs. Gates: every answer's
    tokens equal those of an in-process ``Engine`` on the same params (the
    canonical checkpoint transcoded to int8 at load, its serving tensors
    equal to the served engine's bit for bit) and prompts, replaying the
    server loop's own sequence of submits and steps (so the batches match),
    the logprobs within 1e-5 of its (the answer rounds them to 6 decimals);
    the int8 kernel and K3 launched, nothing else. Records
    requests/s, mean and p99 latency and the streams' time to first token.
    Then ``cli.generate --benchmark --mode codes`` on the canonical
    checkpoint, its printed lines kept. Then the same server with
    ``--draft_model`` (the canonical checkpoint in codes mode: an int8
    target and a codes draft of one AQLM weight, ``--spec_k 4``) answers the
    first SERVE_SPEC_REQUESTS requests, held to a replaying speculative
    Engine by the same gates, the int8 kernel, K1, K2 and K3 launched and
    nothing else; then ``cli.generate --draft_model ... --benchmark`` with
    the same pair, its JSON line kept."""
    from aqlm_tpu_torch.cli.common import resolve_model
    from aqlm_tpu_torch.serve import Engine

    base = ["--host", "127.0.0.1", "--port", "0", "--max_batch", "4", "--kv_int8",
            "--decode_chunk", "8", "--mode", "int8", "--device", dev.type]
    argv = [paths["int8"], *base]
    cfg = entry_config()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENGTHS]
    served = _serve_requests(argv, prompts)
    serve_cfg = served["engine"].serve
    # the replay: a fresh engine on the same params (the canonical checkpoint
    # transcoded to int8 at load, the layout `convert --to int8` wrote: the
    # served engine's tensors, bit for bit), the server loop's calls in order
    t0 = time.perf_counter()
    params, _, _ = resolve_model(paths["canonical"], mode="int8", device=dev)
    engine = Engine(params, cfg, serve_cfg, device=dev)
    del params
    replay_load_s = time.perf_counter() - t0
    replay = _replay(engine, served.pop("engine"), served["calls"], prompts, served["answers"])
    del engine
    torch.cuda.empty_cache()
    serve_rec = _serve_record(argv, prompts, served, replay, replay_load_s,
                              PATH_KERNELS["cli_serve"])
    served_runs = [served["launch_rec"]]
    serve_ok = serve_rec.pop("ok")

    # cli.generate --benchmark: its two printed lines kept
    gen_argv = [paths["canonical"], "--mode", "codes", "--benchmark", "--device", dev.type]
    gen, grec = _generate_cli(gen_argv, PATH_KERNELS["cli_generate"])
    grec["ok"] = grec["ok"] and (gen["new_tokens"] > 1 and len(gen["tokens"]) == 128
                                 and json.loads(grec["lines"][-1])
                                 == {k: gen[k] for k in ("tokens_per_second", "new_tokens")})

    # the same server with a codes draft of the same weight
    draft_args = ["--draft_model", paths["canonical"], "--draft_mode", "codes", "--spec_k", "4"]
    sargv = argv + draft_args
    sprompts = prompts[:SERVE_SPEC_REQUESTS]
    served = _serve_requests(sargv, sprompts)
    served_engine = served.pop("engine")
    spec_state = {"spec_stats": dict(served_engine.spec_stats),
                  "spec_disabled": served_engine.spec_disabled}
    t0 = time.perf_counter()
    params, _, _ = resolve_model(paths["int8"], mode="int8", device=dev)
    dparams, dcfg, _ = resolve_model(paths["canonical"], mode="codes", device=dev)
    engine = Engine(params, cfg, served_engine.serve, device=dev, draft_params=dparams,
                    draft_cfg=dcfg, spec_k=4)
    del params, dparams
    replay_load_s = time.perf_counter() - t0
    replay = _replay(engine, served_engine, served["calls"], sprompts, served["answers"])
    del served_engine
    spec_state["replay_spec_stats"] = dict(engine.spec_stats)
    del engine
    torch.cuda.empty_cache()
    spec_rec = {**_serve_record(sargv, sprompts, served, replay, replay_load_s,
                                PATH_KERNELS["cli_serve_spec"]), **spec_state}
    served_runs.append(served["launch_rec"])
    spec_rec["ok"] = spec_rec["ok"] and spec_state["replay_spec_stats"] == spec_state["spec_stats"]

    sgen_argv = [paths["int8"], "--mode", "int8", *draft_args, "--benchmark", "--device", dev.type]
    sgen, sgrec = _generate_cli(sgen_argv, PATH_KERNELS["cli_generate_spec"])
    line = json.loads(sgrec["lines"][-1])
    sgrec["ok"] = sgrec["ok"] and (sorted(line) == ["acceptance", "new_tokens",
                                                    "tokens_per_second"]
                                   and line["new_tokens"] == len(sgen["tokens"]) == 128
                                   and 0.0 <= line["acceptance"] <= 1.0)
    sgrec["stats"] = sgen["stats"]
    ok = serve_ok and grec["ok"] and spec_rec["ok"] and sgrec["ok"]
    return {"phase": "cli_serve", "serve": serve_rec, "serve_ok": serve_ok,
            "generate": grec, "serve_spec": spec_rec, "generate_spec": sgrec,
            "runs": {"cli_serve": served_runs[0], "cli_generate": grec,
                     "cli_serve_spec": served_runs[1], "cli_generate_spec": sgrec},
            "ok": ok}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from aqlm_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    starting("build")
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
    starting("checks")
    t0 = time.perf_counter()
    with torch.inference_mode():
        reps = check_k1_k2(gen, dev, failures)
        reps.update(check_k3(gen, dev, failures))
        reps.update(check_b6(gen, dev, failures))
        reps.update(check_b8(gen, dev, failures))
        reps.update(check_b16(gen, dev, failures))
        reps.update(check_int8(gen, dev, failures))
        reps.update(check_int4(gen, dev, failures))
        reps.update(check_int8_moe(gen, dev, failures))
        reps.update(check_int4_moe(gen, dev, failures))
        reps.update(check_onehot(gen, dev, failures))
        reps.update(check_moe_codes(gen, dev, failures))
        reps.update(check_gather16(gen, dev, failures))
        reps.update(check_calib(gen, dev, failures))
        check_manual_proj(gen, dev, failures)
        reps.update(check_b10(gen, dev, failures))
        reps.update(check_b5(gen, dev, failures))
    phase_s["checks"] = time.perf_counter() - t0
    if failures:
        print(f"chip_smoke: {len(failures)} kernel checks out of tolerance", file=sys.stderr)
        return 2

    for run in RUNS:
        starting(f"reference_{run}")
        t0 = time.perf_counter()
        ref = reference_check(dev, run)
        phase_s[f"reference_{run}"] = ref["seconds"] = time.perf_counter() - t0
        emit(ref)
        if not ref["ok"]:
            print(f"chip_smoke: {run} kernels disagree with the CPU reference", file=sys.stderr)
            return 3

    runs = {}
    for run in RUNS:
        starting(f"engine_{run}")
        t0 = time.perf_counter()
        runs[run] = engine_run(dev, run)
        phase_s[f"engine_{run}"] = runs[run]["seconds"] = time.perf_counter() - t0
        emit(runs[run])
        if not runs[run]["ok"]:
            print(f"chip_smoke: the {run} engine run failed its checks", file=sys.stderr)
            return 4

    starting("engine_int8_short")
    t0 = time.perf_counter()
    runs["int8_short"] = int8_short_run(dev)
    phase_s["engine_int8_short"] = runs["int8_short"]["seconds"] = time.perf_counter() - t0
    emit(runs["int8_short"])
    if not runs["int8_short"]["ok"]:
        print("chip_smoke: the int8_short engine run failed its checks", file=sys.stderr)
        return 4

    starting("spec")
    t0 = time.perf_counter()
    rec = spec_run(dev)
    phase_s["spec"] = rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    runs.update(rec["runs"])
    if not rec["ok"]:
        print("chip_smoke: the speculative decoding runs failed their checks", file=sys.stderr)
        return 16

    # calibration runs with autograd: outside inference mode
    starting("calibration")
    t0 = time.perf_counter()
    runs["calibration"] = calibration_run(dev)
    phase_s["calibration"] = runs["calibration"]["seconds"] = time.perf_counter() - t0
    emit(runs["calibration"])
    if not runs["calibration"]["ok"]:
        print("chip_smoke: the calibration run failed its checks", file=sys.stderr)
        return 5
    # PV-tuning of the calibrated checkpoint: autograd, outside inference mode
    starting("pv")
    t0 = time.perf_counter()
    pv_codes = {}
    rec = pv_run(dev, pv_codes)
    phase_s["pv"] = rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    runs.update(rec["runs"])
    if not rec["ok"]:
        print("chip_smoke: the PV-tuning run failed its checks", file=sys.stderr)
        return 12
    # the scanned student: the CLI beside pv's runs, then its depth at full width
    starting("pv_scan")
    t0 = time.perf_counter()
    scan = pv_scan_run(dev, rec, pv_codes)
    phase_s["pv_scan"] = scan["seconds"] = time.perf_counter() - t0
    emit(scan)
    runs.update(scan["runs"])
    del pv_codes
    if not scan["ok"]:
        print("chip_smoke: the scanned PV-tuning runs failed their checks", file=sys.stderr)
        return 13
    starting("pv_scan_depth")
    t0 = time.perf_counter()
    runs["pv_scan_depth"] = pv_scan_depth_run(dev)
    phase_s["pv_scan_depth"] = runs["pv_scan_depth"]["seconds"] = time.perf_counter() - t0
    emit(runs["pv_scan_depth"])
    if not runs["pv_scan_depth"]["ok"]:
        print("chip_smoke: the scanned student's depth probe failed its checks", file=sys.stderr)
        return 14
    starting("convert")
    t0 = time.perf_counter()
    rec = convert_run(dev)
    phase_s["convert"] = rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    runs.update(rec["runs"])
    if not rec["ok"]:
        print("chip_smoke: the scheme converters failed their checks", file=sys.stderr)
        return 15
    starting("serve_calibrated")
    t0 = time.perf_counter()
    runs["serve_calibrated"] = serve_calibrated(dev)
    phase_s["serve_calibrated"] = runs["serve_calibrated"]["seconds"] = time.perf_counter() - t0
    emit(runs["serve_calibrated"])
    if not runs["serve_calibrated"]["ok"]:
        print("chip_smoke: serving the calibrated checkpoint failed its checks", file=sys.stderr)
        return 6

    # LoRA training: autograd, outside inference mode
    for mode in LORA_RUNS.values():
        starting(f"lora_reference_{mode}")
        t0 = time.perf_counter()
        ref = lora_reference(dev, mode)
        phase_s[f"lora_reference_{mode}"] = ref["seconds"] = time.perf_counter() - t0
        emit(ref)
        if not ref["ok"]:
            print(f"chip_smoke: the {mode} training step disagrees with the CPU", file=sys.stderr)
            return 7
    for run in LORA_RUNS:
        starting(run)
        t0 = time.perf_counter()
        runs[run] = lora_run(dev, run)
        phase_s[run] = runs[run]["seconds"] = time.perf_counter() - t0
        emit(runs[run])
        if not runs[run]["ok"]:
            print(f"chip_smoke: the {run} training run failed its checks", file=sys.stderr)
            return 8

    # the entry points a user calls, on one canonical checkpoint written here
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="entry_checkpoints_", dir="build")
    try:
        starting("entry_checkpoints")
        t0 = time.perf_counter()
        ckpts = write_entry_checkpoints(dev, root)
        phase_s["entry_checkpoints"] = time.perf_counter() - t0
        emit({"phase": "entry_checkpoints", **ckpts, "total_s": phase_s["entry_checkpoints"]})
        starting("unstacked_decode")
        t0 = time.perf_counter()
        runs["unstacked_decode"] = unstacked_decode(dev, ckpts["paths"])
        phase_s["unstacked_decode"] = runs["unstacked_decode"]["seconds"] = time.perf_counter() - t0
        emit(runs["unstacked_decode"])
        if not runs["unstacked_decode"]["ok"]:
            print("chip_smoke: the unstacked forward failed its checks", file=sys.stderr)
            return 9
        starting("evaluate")
        t0 = time.perf_counter()
        rec = evaluate_run(dev, ckpts["paths"])
        phase_s["evaluate"] = rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        runs.update({f"evaluate_{mode}": r for mode, r in rec["runs"].items()})
        if not rec["ok"]:
            print("chip_smoke: the evaluate CLI failed its checks", file=sys.stderr)
            return 10
        starting("cli_serve")
        t0 = time.perf_counter()
        rec = cli_serve_run(dev, ckpts["paths"])
        phase_s["cli_serve"] = rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        runs.update(rec["runs"])
        if not rec["ok"]:
            print("chip_smoke: the serve or generate CLI failed its checks", file=sys.stderr)
            return 11
    finally:
        shutil.rmtree(root, ignore_errors=True)

    emit({"phase": "seconds", **phase_s, "total": time.perf_counter() - T_START})
    kernels = []
    for name, info in _build.KERNELS.items():
        r = reps[name]
        by_run = {run: rec["launches"][name] for run, rec in runs.items()
                  if name in PATH_KERNELS[run]}
        # B6 and B16 are on no path (nor in aqlm_tpu's engine): phase 2 alone launches them
        aside = {} if by_run else {"launches_note": "on no path: launched by phase 2's checks only"}
        forms = {run: rec["forms"][name] for run, rec in runs.items()
                 if name in PATH_KERNELS[run] and name in rec.get("forms", {})}
        if forms:  # K1, K2, int8, int4: launches by wrapper form (unindexed, indexed)
            aside["forms_by_run"] = forms
        kernels.append({"name": name, "route": "cuda", "source": info.source,
                        "replaces": info.replaces, "also_replaces": list(info.also_replaces),
                        "launches": sum(by_run.values()), "launches_by_run": by_run, **aside,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **({"plan": r["plan"]} if "plan" in r else {}),
                        "shape": {k: r[k] for k in r if k in (
                            "proj", "experts", "rows", "kv", "window", "B", "max_len", "groups",
                            "form", "cache", "lengths", "splits", "keys_per_split", "lanes",
                            "out_features", "in_features", "precise")}})
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
