"""Checkpoint conversion CLI (PyTorch counterpart of ``aqlm_tpu.cli.convert``),
and ``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

    python -m aqlm_tpu_torch.cli.convert MODEL_DIR OUT_DIR --to int8

``--to canonical`` rewrites the canonical checkpoint; ``--to
int8|int4|codes`` materializes that runtime serving layout into the
checkpoint, so serving loads it as it is instead of transcoding at load.
``--to 2x8|2x7`` re-fits each 1x16 projection's codebook as the sum of two
256- or 128-row books (``ops.transcode``, ``--transcode_iters``) so the Kx8
codes kernels serve it; ``--to requant`` fits a fresh ``--scheme`` to each
projection's dequantized weight (``calib.requantize``: k-means init, then
``--refine_iters`` rounds of the weight-L2 beam search of ``--beam_size``
and a codebook refit; no calibration data), e.g. a 1x8 draft model. Both
print each projection's relative MSE and record the worst in the
checkpoint's config. Not ported: ``--to hf`` and ``--from_format
legacy|legacy_fsdp`` (ROADMAP A10).
"""

from __future__ import annotations

import argparse

from aqlm_tpu_torch.cli.common import resolve_model
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.io import save_quantized_model
from aqlm_tpu_torch.models.quantize import convert_runtime_mode
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported

# the targets of aqlm_tpu's CLI that wait for a later item, by ROADMAP item
_UNPORTED = {"hf": ("the HF AQLM export (--to hf)", "A10")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="model dir (canonical)")
    p.add_argument("output", help="destination dir")
    p.add_argument("--to", choices=["hf", "canonical", "2x8", "2x7", "requant", "int8", "int4",
                                    "codes"], required=True,
                   help="canonical: rewrite the canonical checkpoint; int8|int4|codes: "
                        "materialize the runtime serving layout into the checkpoint; "
                        "2x8|2x7: re-fit 1x16 codebooks as sums of two 256- or 128-row "
                        "books; requant: fit a fresh --scheme to the dequantized weights")
    p.add_argument("--transcode_iters", type=int, default=25)
    p.add_argument("--scheme", default="1x8",
                   help="destination scheme for --to requant (e.g. 1x8, 2x8, 8x8)")
    p.add_argument("--refine_iters", type=int, default=2,
                   help="requant: alternating L2-beam-search/codebook-lstsq rounds")
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--from_format", choices=["auto", "legacy", "legacy_fsdp"], default="auto")
    p.add_argument("--base_config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return p


def _transcode(params: dict, nbits: int, iters: int) -> tuple[dict, float]:
    """Every 1x16 projection transcoded to 2x``nbits`` in place (reference
    mode); the worst codebook rel-MSE."""
    from aqlm_tpu_torch.ops.dequant import AqlmWeight
    from aqlm_tpu_torch.ops.transcode import transcode_1x16_to_2xN

    worst = 0.0
    for li, layer in enumerate(params["layers"]):
        for name, q in list(layer.items()):
            if isinstance(q, QuantizedLinear) and q.scheme.nbits_per_codebook == 16:
                w = AqlmWeight(codes=q.codes, codebooks=q.codebooks, scales=q.scales,
                               bias=q.bias, scheme=q.scheme)
                w2, rel = transcode_1x16_to_2xN(w, nbits=nbits, iters=iters)
                layer[name] = QuantizedLinear.from_aqlm(w2, mode="reference")
                worst = max(worst, rel)
                print(f"layer {li} {name}: codebook rel-MSE {rel:.4f}")
    return params, worst


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if args.from_format != "auto":
        raise not_ported(f"importing the reference's {args.from_format} format", "A10")
    if args.to in _UNPORTED:
        raise not_ported(*_UNPORTED[args.to])
    params, cfg, kind = resolve_model(args.input, mode="reference",
                                      device=resolve_device(args.device))
    assert kind == "quantized", "conversion applies to quantized checkpoints"
    extra = None
    if args.to in ("2x8", "2x7"):
        params, worst = _transcode(params, int(args.to[-1]), args.transcode_iters)
        extra = {"transcoded_from": "1x16", "worst_rel_mse": worst}
    elif args.to == "requant":
        from aqlm_tpu_torch.calib.requantize import requantize_params
        from aqlm_tpu_torch.config import AqlmScheme

        params, worst = requantize_params(params, AqlmScheme.parse(args.scheme),
                                          refine_iters=args.refine_iters,
                                          beam_size=args.beam_size, verbose=True)
        extra = {"requantized_to": args.scheme, "worst_rel_mse": worst}
    elif args.to != "canonical":
        params = convert_runtime_mode(params, args.to)
    save_quantized_model(args.output, params, cfg, extra_config=extra)
    if extra is not None:
        kind_of_mse = "codebook" if args.to != "requant" else "weight"
        print(f"worst per-projection {kind_of_mse} rel-MSE: {worst:.4f}")
    print(f"converted {args.input} ({kind}) -> {args.output} [{args.to}]")
    return args.output


if __name__ == "__main__":
    main()
