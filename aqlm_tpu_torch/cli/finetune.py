"""PV-tuning CLI (PyTorch counterpart of ``aqlm_tpu.cli.finetune``): teacher ->
student KL distillation with straight-through code updates, on one card.
The same flags, and ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).

    python -m aqlm_tpu_torch.cli.finetune --base_model random:llama2_7b:2 \\
        --quantized_model QDIR --dataset random --total_steps 100 --save OUT

- ``--microbatch_size`` < ``--batch_size`` accumulates gradients;
- ``--loss_tokens_per_chunk`` chunks the lm_head + KL (0: full logits);
- ``--st_window N`` keeps N layers' straight-through buffers on the card a
  step, rotating round-robin, with every layer's buffers and their Adam in
  host memory (``pv.host.HostSTManager``);
- ``--scan_blocks`` runs the student as ``pv.straight_through.
  scanned_student_hidden`` (llama-family students quantized in every
  projection): its manual projections re-dequantize in the backward (B13,
  B14 on the card), so it holds one block's dense weights at a time. With
  ``--st_window`` the window goes to the card as a stack with its first
  layer's index: the gradient pass gets a zeros window (its value does not
  enter the gradients), the ST gradients come down in bf16 to the host
  Adam, and the updated buffers go up in bf16 for the V step (f32 with
  ``--delta_decay``, whose mixed buffers are then stored back);
- ``--offload_teacher`` keeps the teacher's weights in host memory and
  streams its forward a layer at a time, ``--teacher_stream_group`` batches a
  pass, in a background thread (``pv.teacher``). The teacher keeps its own
  dtype there (JAX's CLI casts it to bf16), so the run's losses are the
  plain run's.

The teacher is ``random:<preset>[:layers]`` or a canonical checkpoint with no
quantized layer; the student a canonical quantized checkpoint, trained in
reference mode (B13 forward, B14 backward on the card). Batches are drawn
with ``np.random.RandomState(seed)`` as JAX's CLI draws them, a resume
included. Prints a final JSON line: ``final_kl``, ``losses`` (at most 20,
as JAX's), ``step_losses`` (every step) and ``seconds`` (each step's
gradient pass, update and V step). Not ported: ``--mesh_data`` /
``--mesh_model`` > 1 (ROADMAP A14), ``--wandb`` (A15); of the datasets only
``random`` and token files load (A11).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from aqlm_tpu_torch.cli.common import dtype_from_str, load_calibration_data, resolve_model
from aqlm_tpu_torch.data import evaluate_perplexity
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.io import save_quantized_model
from aqlm_tpu_torch.io.train_state import load_pytree, save_pytree
from aqlm_tpu_torch.models.family import family_name
from aqlm_tpu_torch.models.family import forward_fn as family_forward
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported
from aqlm_tpu_torch.pv import (
    PVConfig,
    configurable_adamw,
    init_pv_state,
    make_pv_step,
    merge_trainable,
)
from aqlm_tpu_torch.pv.trainer import tree_map
from aqlm_tpu_torch.utils.monitoring import MetricLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base_model", required=True, help="dense teacher checkpoint")
    p.add_argument("--quantized_model", required=True, help="quantized student (canonical)")
    p.add_argument("--dataset", default="random")
    p.add_argument("--nsamples", type=int, default=256)
    p.add_argument("--val_size", type=int, default=0,
                   help="held-out sequences for eval (split off the dataset)")
    p.add_argument("--model_seqlen", type=int, default=4096)
    p.add_argument("--batch_size", type=int, default=4, help="global batch per step")
    p.add_argument("--microbatch_size", type=int, default=None,
                   help="per-forward batch; < batch_size accumulates gradients")
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--code_update_every", type=int, default=1, help="V steps per P step")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--code_lr", type=float, default=1e-3)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--delta_decay", type=float, default=0.0)
    p.add_argument("--max_code_change_per_step", type=float, default=1e-2)
    p.add_argument("--code_trust_ratio", type=float, default=None)
    p.add_argument("--code_selection_temperature", type=float, default=0.0)
    p.add_argument("--force_code_update", action="store_true")
    p.add_argument("--stochastic_rounding_tau", type=float, default=0.0)
    p.add_argument("--loss_tokens_per_chunk", type=int, default=256,
                   help="chunked lm_head+KL (0 = full logits)")
    p.add_argument("--st_window", type=int, default=0,
                   help=">0: only N layers' ST buffers on the card a step (host Adam, "
                        "round-robin rotation)")
    p.add_argument("--scan_blocks", action="store_true",
                   help="student as a loop over blocks whose backward holds one block's "
                        "dense weights (llama-family, fully quantized students only)")
    p.add_argument("--offload_teacher", action="store_true",
                   help="teacher weights in host memory, layer-streamed forward")
    p.add_argument("--teacher_stream_group", type=int, default=4,
                   help="with --offload_teacher: batches sharing one weight-streaming pass, "
                        "prefetched in a background thread")
    p.add_argument("--lamb", action="store_true")
    p.add_argument("--amsgrad", action="store_true")
    p.add_argument("--debias", action="store_true", default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--exp_avg_dtype", choices=["float32", "bfloat16"], default=None,
                   help="reduced-precision first moments")
    p.add_argument("--exp_avg_sq_dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--eval_every_steps", type=int, default=0)
    p.add_argument("--eval_datasets", nargs="*", default=[])
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--save_state_every", type=int, default=0,
                   help="checkpoint the full training state every N steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save>/train_state.npz if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=1, help="multi-device: not ported")
    p.add_argument("--mesh_model", type=int, default=1, help="multi-device: not ported")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default="auto")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def _sync(dev: torch.device) -> float:
    """The card's queue drained; the time then."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise not_ported("multi-device PV-tuning (--mesh_data/--mesh_model)", "A14")
    logger = MetricLogger(use_wandb=args.wandb)
    dev = resolve_device(args.device)
    dtype = dtype_from_str(args.dtype)
    micro = args.microbatch_size or args.batch_size
    if args.batch_size % micro:
        raise ValueError("batch_size must divide by microbatch_size")
    n_micro = args.batch_size // micro

    teacher, teacher_cfg, _ = resolve_model(args.base_model, dtype=dtype, device=dev)
    if any(isinstance(v, QuantizedLinear) for layer in teacher["layers"] for v in layer.values()):
        raise ValueError("the teacher must be a dense model")
    student, student_cfg, kind = resolve_model(args.quantized_model, dtype=dtype,
                                               mode="reference", device=dev)
    if kind != "quantized":
        raise ValueError("the student must be a quantized model")
    if family_name(student_cfg) != "llama":
        if args.scan_blocks:
            raise ValueError("scan_blocks supports llama-family students only")
        if args.offload_teacher:
            raise ValueError("the host-streamed teacher supports the llama family only")

    data = load_calibration_data(args.dataset, args.nsamples + args.val_size, args.model_seqlen,
                                 teacher_cfg, seed=args.seed)
    val_data = data[:args.val_size] if args.val_size else None
    data = data[args.val_size:]

    pv = PVConfig(
        lr=args.lr, code_lr=args.code_lr, beam_size=args.beam_size,
        delta_decay=args.delta_decay, max_code_change_per_step=args.max_code_change_per_step,
        code_trust_ratio=args.code_trust_ratio,
        code_selection_temperature=args.code_selection_temperature,
        force_code_update=args.force_code_update,
        stochastic_rounding_tau=args.stochastic_rounding_tau,
        chunk_tokens=args.loss_tokens_per_chunk, scan_blocks=args.scan_blocks)
    moment_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}
    cont_opt = configurable_adamw(
        pv.lr, b1=0.9, b2=0.95, weight_decay=args.weight_decay, lamb=args.lamb,
        amsgrad=args.amsgrad, debias=args.debias,
        exp_avg_dtype=moment_dtype[args.exp_avg_dtype],
        exp_avg_sq_dtype=moment_dtype[args.exp_avg_sq_dtype])
    st_opt = configurable_adamw(pv.code_lr, b1=0.9, b2=0.95)

    host_teacher, teacher_kind = None, "params"
    if args.offload_teacher:
        from aqlm_tpu_torch.pv.teacher import HostTeacher

        host_teacher = HostTeacher(teacher, teacher_cfg, dtype=teacher["embed"].dtype,
                                   device=dev)
        teacher, teacher_kind = None, "hidden"  # the card's copy goes

    st_mgr, active = None, None
    if args.st_window:
        from aqlm_tpu_torch.pv.host import HostSTManager

        # the buffers' Adam runs on the host; bf16 first moments are kept in
        # f16 there, as JAX's CLI keeps them (numpy has no bf16)
        st_opt = None
        host_moment = torch.float16 if moment_dtype[args.exp_avg_dtype] == torch.bfloat16 \
            else torch.float32
        st_mgr = HostSTManager(student, window=args.st_window, lr=pv.code_lr,
                               moment_dtype=host_moment)
        active = st_mgr.active_window(0)

    fns = make_pv_step(student_cfg, teacher_cfg, pv, teacher_kind=teacher_kind,
                       forward_fn=family_forward(student_cfg))
    state = init_pv_state(student, cont_opt, st_opt, active_layers=active)
    del student  # the state holds copies of the trainable tensors and shares the codes

    start_step = 0
    state_path = os.path.join(args.save, "train_state.npz") if args.save else None
    if args.resume and state_path and os.path.exists(state_path):
        state, meta = load_pytree(state_path, state)
        start_step = int(meta.get("step", 0))
        print(f"resumed training state at step {start_step}")

    rng = np.random.RandomState(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    n = data.shape[0]
    for _ in range(start_step * n_micro):  # replay the batch stream to the resume point
        rng.randint(0, n, size=micro)
    teacher_iter = None
    if host_teacher is not None:
        from aqlm_tpu_torch.pv.teacher import TeacherPrefetcher

        def _batch_stream():
            # the inline draw's stream; only the prefetch worker advances rng now
            while True:
                yield data[torch.from_numpy(rng.randint(0, n, size=micro))]

        teacher_iter = TeacherPrefetcher(host_teacher, _batch_stream(),
                                         group_size=args.teacher_stream_group)
    losses = []
    seconds = {"grad": [], "apply": [], "code": []}
    add = lambda a, b: None if a is None else a + b
    windowed = st_mgr is not None and args.scan_blocks  # the window as a stack + its start

    def zeros_window(active):
        # the ST correction st - st.detach() is zero and dL/d(st) is dL/dW
        # whatever st holds, so the gradient pass needs no upload of the buffers
        return {name: torch.zeros((len(active),) + tuple(buf.shape), dtype=torch.float32,
                                  device=dev)
                for name, buf in st_mgr.buffers[active[0]].items()}

    try:
        for step in range(start_step, args.total_steps):
            t0 = _sync(dev)
            win_start = None
            if st_mgr is not None:
                active = st_mgr.active_window(step)
                if windowed:
                    win_start = active[0]
                    state.st_buffers = zeros_window(active)
                else:
                    state.st_buffers = st_mgr.fetch(active, dev)
            acc, loss_sum = None, 0.0
            for _ in range(n_micro):
                if teacher_iter is not None:
                    batch, t_in = next(teacher_iter)
                else:
                    batch, t_in = data[torch.from_numpy(rng.randint(0, n, size=micro))], teacher
                loss, grads = fns.grad_fn(state, t_in, batch.to(dev), None, win_start)
                loss_sum += float(loss)
                acc = grads if acc is None else tree_map(add, acc, grads)
            t1 = _sync(dev)
            if st_mgr is not None:
                g_tr, g_st = acc
                if windowed:  # down in bf16, re-accumulated in f32 by the host Adam
                    g_st = st_mgr.window_to_list(active, {
                        k: v.to(torch.bfloat16).cpu().float() for k, v in g_st.items()})
                st_mgr.adam_update(active, [{k: v / n_micro for k, v in e.items()} for e in g_st])
                if windowed:
                    # the buffers only feed the V step's search: up in bf16 unless
                    # delta-decay mixes them (stored back below)
                    up = torch.float32 if pv.delta_decay != 0 else torch.bfloat16
                    state.st_buffers = {k: v.to(dev, up)
                                        for k, v in st_mgr.fetch_window(active).items()}
                else:
                    state.st_buffers = st_mgr.fetch(active, dev)
                acc = (g_tr, None)  # no st optimizer: the host updated the buffers
            state = fns.apply_fn(state, acc, 1.0 / n_micro)
            losses.append(loss_sum / n_micro)
            t2 = _sync(dev)
            seconds["grad"].append(t1 - t0)
            seconds["apply"].append(t2 - t1)
            if args.code_update_every and (step + 1) % args.code_update_every == 0:
                state = fns.code_step(state, generator, active=active)
                # with delta_decay 0 the V step leaves the buffers as they are, and
                # storing the windowed bf16 upload would round the host's f32 state
                if st_mgr is not None and (pv.delta_decay != 0 or not windowed):
                    st_mgr.store(active, st_mgr.window_to_list(active, state.st_buffers)
                                 if windowed else state.st_buffers)
                seconds["code"].append(_sync(dev) - t2)
            if args.save_state_every and state_path and (step + 1) % args.save_state_every == 0:
                save_pytree(state_path, state, metadata={"step": step + 1})
            if step % 10 == 0:
                logger.log({"kl_loss": losses[-1]}, step=step)
                print(f"step {step}: kl={losses[-1]:.5f}")
            if args.eval_every_steps and (step + 1) % args.eval_every_steps == 0:
                params = merge_trainable(state.trainable, state.frozen)
                fwd = family_forward(student_cfg)
                if val_data is not None:
                    ppl = evaluate_perplexity(params, student_cfg, val_data, forward_fn=fwd)
                    logger.log({"ppl_val": ppl}, step=step)
                    print(f"step {step}: val ppl={ppl:.4f}")
                for ds in args.eval_datasets:
                    ids = load_calibration_data(ds, 8, args.model_seqlen, teacher_cfg,
                                                eval_mode=True)[:8]
                    ppl = evaluate_perplexity(params, student_cfg, ids, forward_fn=fwd)
                    logger.log({f"ppl_{ds}": ppl}, step=step)
                    print(f"step {step}: {ds} ppl={ppl:.4f}")

    finally:
        if teacher_iter is not None:
            teacher_iter.close()

    params = merge_trainable(state.trainable, state.frozen)
    if args.save:
        save_quantized_model(args.save, params, student_cfg,
                             extra_config={"cli_args": vars(args)})
        print(f"saved PV-tuned model to {args.save}")
    result = {"final_kl": losses[-1] if losses else None,
              "losses": losses[::max(1, len(losses) // 20)], "step_losses": losses,
              "seconds": seconds}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
