"""Quantization CLI (PyTorch counterpart of ``aqlm_tpu.cli.quantize``): the
same flags, and ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).

    python -m aqlm_tpu_torch.cli.quantize random:llama2_7b:2 random \\
        --num_codebooks 2 --nbits_per_codebook 8 --in_group_size 8 --save out_dir

Prints a final JSON line of the stats (``avg_bits``, ``quantization_time_s``,
``memory``, seconds by part, and ``ppl_<dataset>`` of each
``--eval_datasets`` entry, evaluated on the quantized model after the save).
Not ported: ``--mesh_*`` > 1 (ROADMAP A14), the HF datasets (A11) and
``--wandb`` (A15).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from aqlm_tpu_torch.calib import (
    BlockFinetuneConfig,
    CalibConfig,
    QuantizePipelineConfig,
    quantize_model,
)
from aqlm_tpu_torch.cli.common import dtype_from_str, load_calibration_data, resolve_model
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.data import evaluate_perplexity
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.io import save_quantized_model
from aqlm_tpu_torch.models.family import forward_fn, taps_fn
from aqlm_tpu_torch.ops.runtime import not_ported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_path", help="canonical dir, or random:<preset>[:layers]")
    p.add_argument("dataset", help="random | path to tokenized .npy/.npz")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--model_seqlen", type=int, default=4096)
    p.add_argument("--val_size", type=int, default=0)
    p.add_argument("--num_codebooks", type=int, default=1)
    p.add_argument("--nbits_per_codebook", type=int, default=16)
    p.add_argument("--out_group_size", type=int, default=1)
    p.add_argument("--in_group_size", type=int, default=8)
    p.add_argument("--scale_nbits", type=int, default=0)
    p.add_argument("--codebook_value_nbits", type=int, default=16)
    p.add_argument("--codebook_value_num_groups", type=int, default=1)
    p.add_argument("--mix_compression", action="store_true",
                   help="attention projections at 2x num_codebooks, MLP at the base scheme")
    p.add_argument("--init_max_iter", type=int, default=100)
    p.add_argument("--init_max_points_per_centroid", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--max_epochs", type=int, default=1000)
    p.add_argument("--relative_mse_tolerance", type=float, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--finetune_max_epochs", type=int, default=5)
    p.add_argument("--finetune_early_stop", type=int, default=3)
    p.add_argument("--finetune_lr", type=float, default=1e-5)
    p.add_argument("--finetune_batch_size", type=int, default=1)
    p.add_argument("--finetune_adam_beta1", type=float, default=0.9)
    p.add_argument("--finetune_adam_beta2", type=float, default=0.95)
    p.add_argument("--use_checkpointing", action="store_true",
                   help="recompute the block forward during blockwise finetune")
    p.add_argument("--true-sequential", action="store_true", dest="true_sequential")
    p.add_argument("--batch_size", type=int, default=4, help="activation-capture batch")
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--offload_activations", action="store_true",
                   help="keep layer activations in host memory")
    p.add_argument("--on_save", type=str, default=None,
                   help="python snippet exec'd after each layer checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=1, help="multi-device: not ported")
    p.add_argument("--mesh_model", type=int, default=1, help="multi-device: not ported")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default="auto")
    p.add_argument("--eval_datasets", nargs="*", default=[])
    p.add_argument("--eval_nsamples", type=int, default=16)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def _memory(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {}
    return {"peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_in_use": torch.cuda.memory_allocated(dev)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise not_ported("multi-device calibration (--mesh_data/--mesh_model)", "A14")
    if args.wandb:
        raise not_ported("metric logging to wandb", "A15")
    dev = resolve_device(args.device)
    params, cfg, kind = resolve_model(args.model_path, dtype=dtype_from_str(args.dtype),
                                      device=dev)
    if kind != "dense":
        raise ValueError("quantize expects a dense model")
    data = load_calibration_data(args.dataset, args.nsamples + args.val_size, args.model_seqlen,
                                 cfg, seed=args.seed)
    val_data = data[args.nsamples:] if args.val_size else None
    data = data[:args.nsamples]

    pipe = QuantizePipelineConfig(
        scheme=AqlmScheme(num_codebooks=args.num_codebooks,
                          nbits_per_codebook=args.nbits_per_codebook,
                          in_group_size=args.in_group_size, out_group_size=args.out_group_size),
        calib=CalibConfig(
            lr=args.lr, beam_size=args.beam_size, max_epochs=args.max_epochs,
            steps_per_epoch=args.steps_per_epoch,
            relative_mse_tolerance=args.relative_mse_tolerance,
            init_max_iter=args.init_max_iter,
            init_max_points_per_centroid=args.init_max_points_per_centroid, seed=args.seed,
            scale_nbits=args.scale_nbits, codebook_value_nbits=args.codebook_value_nbits,
            codebook_value_num_groups=args.codebook_value_num_groups),
        finetune=BlockFinetuneConfig(
            lr=args.finetune_lr, max_epochs=args.finetune_max_epochs,
            early_stop=args.finetune_early_stop, batch_size=args.finetune_batch_size,
            adam_beta1=args.finetune_adam_beta1, adam_beta2=args.finetune_adam_beta2,
            use_checkpointing=args.use_checkpointing),
        true_sequential=args.true_sequential, batch_size=args.batch_size, save_dir=args.save,
        resume=args.resume, offload_activations=args.offload_activations, on_save=args.on_save,
    )
    if args.mix_compression:
        # attention projections at 2x the codebooks of the MLP (the reference's MoE recipe)
        attn = dataclasses.replace(pipe.scheme, num_codebooks=2 * pipe.scheme.num_codebooks)
        pipe = dataclasses.replace(pipe, scheme_overrides=tuple(
            (n, attn) for n in ("q_proj", "k_proj", "v_proj", "o_proj")))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params, stats = quantize_model(params, cfg, data, pipe, val_input_ids=val_data,
                                   taps_fn=taps_fn(cfg))
    stats["quantization_time_s"] = time.time() - t0
    stats["memory"] = _memory(dev)
    if args.save:
        save_quantized_model(args.save, params, cfg, extra_config={"cli_args": vars(args)})
        print(f"saved quantized model to {args.save}")
    for ds in args.eval_datasets:
        eval_ids = load_calibration_data(ds, args.eval_nsamples, args.model_seqlen, cfg,
                                         seed=args.seed + 1, eval_mode=True)[:args.eval_nsamples]
        ppl = evaluate_perplexity(params, cfg, eval_ids, forward_fn=forward_fn(cfg))
        stats[f"ppl_{ds}"] = ppl
        print(f"{ds} perplexity: {ppl:.4f}")
    print(json.dumps({k: v for k, v in stats.items() if not isinstance(v, list)}, default=str))
    return stats


if __name__ == "__main__":
    main()
