"""Checkpoint conversion CLI (PyTorch counterpart of ``aqlm_tpu.cli.convert``),
and ``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

    python -m aqlm_tpu_torch.cli.convert MODEL_DIR OUT_DIR --to int8

``--to canonical`` rewrites the canonical checkpoint; ``--to
int8|int4|codes`` materializes that runtime serving layout into the
checkpoint, so serving loads it as it is instead of transcoding at load.
Not ported: ``--to hf`` and ``--from_format legacy|legacy_fsdp`` (ROADMAP
A10), ``--to 2x8|2x7`` (A8) and ``--to requant`` (A13, with the L2 beam
search it uses).
"""

from __future__ import annotations

import argparse

from aqlm_tpu_torch.cli.common import resolve_model
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.io import save_quantized_model
from aqlm_tpu_torch.models.quantize import convert_runtime_mode
from aqlm_tpu_torch.ops.runtime import not_ported

# the targets of aqlm_tpu's CLI that wait for a later item, by ROADMAP item
_UNPORTED = {"hf": ("the HF AQLM export (--to hf)", "A10"),
             "2x8": ("the 1x16 -> 2x8 transcode (--to 2x8)", "A8"),
             "2x7": ("the 1x16 -> 2x7 transcode (--to 2x7)", "A8"),
             "requant": ("re-quantization to another scheme (--to requant)", "A13")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="model dir (canonical)")
    p.add_argument("output", help="destination dir")
    p.add_argument("--to", choices=["hf", "canonical", "2x8", "2x7", "requant", "int8", "int4",
                                    "codes"], required=True,
                   help="canonical: rewrite the canonical checkpoint; int8|int4|codes: "
                        "materialize the runtime serving layout into the checkpoint")
    p.add_argument("--transcode_iters", type=int, default=25)
    p.add_argument("--scheme", default="1x8")
    p.add_argument("--refine_iters", type=int, default=2)
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--from_format", choices=["auto", "legacy", "legacy_fsdp"], default="auto")
    p.add_argument("--base_config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if args.from_format != "auto":
        raise not_ported(f"importing the reference's {args.from_format} format", "A10")
    if args.to in _UNPORTED:
        raise not_ported(*_UNPORTED[args.to])
    params, cfg, kind = resolve_model(args.input, mode="reference",
                                      device=resolve_device(args.device))
    assert kind == "quantized", "conversion applies to quantized checkpoints"
    if args.to != "canonical":
        params = convert_runtime_mode(params, args.to)
    save_quantized_model(args.output, params, cfg)
    print(f"converted {args.input} ({kind}) -> {args.output} [{args.to}]")
    return args.output


if __name__ == "__main__":
    main()
