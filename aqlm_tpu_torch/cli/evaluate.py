"""Evaluation CLI (PyTorch counterpart of ``aqlm_tpu.cli.evaluate``):
perplexity by the GPTQ protocol, and ``--device`` (default ``cuda``;
``cpu`` runs the plain versions).

    python -m aqlm_tpu_torch.cli.evaluate MODEL_DIR --datasets random \\
        --nsamples 8 --model_seqlen 4096 --mode codes

Prints ``<dataset> perplexity: <ppl>`` per dataset, then the result dict as
a JSON line. Data: ``random`` ids or a tokenized .npy/.npz; the HF datasets
are not ported (ROADMAP A11), nor is ``--mesh_data > 1`` (A14). Harness
``--tasks`` are skipped when ``lm_eval`` cannot be imported, as in
``aqlm_tpu``; where it can, they raise A11.
"""

from __future__ import annotations

import argparse
import json

from aqlm_tpu_torch.cli.common import dtype_from_str, load_calibration_data, resolve_model
from aqlm_tpu_torch.data import evaluate_perplexity, make_lm_eval_adapter
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.family import forward_fn
from aqlm_tpu_torch.ops.runtime import not_ported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_path")
    p.add_argument("--datasets", nargs="+", default=["wikitext2"])
    p.add_argument("--model_seqlen", type=int, default=4096)
    p.add_argument("--nsamples", type=int, default=0, help="0 = full eval split")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"], default="auto")
    p.add_argument("--mode", choices=["reference", "codes", "int8", "int4"], default="reference")
    p.add_argument("--tasks", nargs="*", default=[], help="lm-eval harness tasks (requires lm_eval)")
    p.add_argument("--mesh_data", type=int, default=1, help="multi-device: not ported")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mesh_data > 1:
        raise not_ported("data-parallel evaluation (--mesh_data)", "A14")
    dev = resolve_device(args.device)
    params, cfg, kind = resolve_model(args.model_path, dtype=dtype_from_str(args.dtype),
                                      mode=args.mode, device=dev)
    results = {"model": args.model_path, "kind": kind}
    for ds in args.datasets:
        ids = load_calibration_data(ds, args.nsamples, args.model_seqlen, cfg, eval_mode=True)
        if args.nsamples:
            ids = ids[:args.nsamples]
        ppl = evaluate_perplexity(params, cfg, ids, batch_size=args.batch_size,
                                  forward_fn=forward_fn(cfg))
        results[f"ppl_{ds}"] = ppl
        print(f"{ds} perplexity: {ppl:.4f}")

    if args.tasks:
        try:
            import lm_eval  # noqa: F401
        except ImportError:
            print("lm_eval not installed; skipping harness tasks")
        else:
            make_lm_eval_adapter(params, cfg, None)

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
