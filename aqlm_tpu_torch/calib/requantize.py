"""Weight-L2 requantization: an AQLM checkpoint to another scheme without
calibration data (PyTorch counterpart of ``aqlm_tpu.calib.requantize``).

Each projection is dequantized and fit anew in the destination scheme with
calibration's own machinery without its XTX term: the scale and residual
k-means init (``calib.engine.init_quantized_weight``), then rounds of the
weight-L2 beam search (``calib.beam_search_l2``) and a least-squares
codebook refit. It is the PV V step's objective applied once per
projection. Its sibling ``ops.transcode`` re-fits 1x16 codebooks as sums of
two small books instead (``cli.convert --to 2x8|2x7``).

Uses: a low-bit draft model for speculative serving from the target's own
checkpoint, and checkpoints in the schemes the codes kernels serve (Kx8).
Random draws come from a ``torch.Generator`` where JAX splits PRNG keys.
"""

from __future__ import annotations

import dataclasses

import torch

from aqlm_tpu_torch.calib.beam_search_l2 import (
    beam_search_optimal_codes_l2,
    find_optimal_codebooks,
)
from aqlm_tpu_torch.calib.engine import init_quantized_weight
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops.dequant import AqlmWeight, dequantize_weight

__all__ = ["requantize_weight", "requantize_params"]


def requantize_weight(w: AqlmWeight, new_scheme: AqlmScheme, *,
                      generator: torch.Generator | None = None, refine_iters: int = 2,
                      beam_size: int = 2, kmeans_iter: int = 50) -> tuple[AqlmWeight, float]:
    """Fit ``new_scheme`` codes and codebooks to w's dequantized weight.

    ``generator`` (on w's device; seed 0 if None) draws the k-means init.
    Returns (the new AqlmWeight with w's bias, the relative weight MSE
    ||W_new - W||^2 / ||W||^2)."""
    if new_scheme.codebook_size > 1024:
        raise ValueError("requantize refits codebooks by dense lstsq over [K*S, K*S] code "
                         "co-occurrence; target Kx8-style schemes (S<=1024), not 1x16")
    if generator is None:
        generator = torch.Generator(device=w.codes.device).manual_seed(0)
    W = dequantize_weight(w, dtype=torch.float32)
    new = init_quantized_weight(W, new_scheme, generator=generator, max_iter=kmeans_iter)

    og, ig = new_scheme.out_group_size, new_scheme.in_group_size
    OG, IG, K = new.codes.shape
    S = new_scheme.codebook_size
    groups = W.reshape(OG, og, IG, ig).transpose(1, 2)  # [OG, IG, og, ig]
    sc2 = new.scales.reshape(OG, 1).expand(OG, IG) if new.scales.ndim == 1 else new.scales
    ref_groups = (groups / sc2[:, :, None, None]).reshape(OG * IG, og * ig)
    for _ in range(refine_iters):
        codes = beam_search_optimal_codes_l2(W, new.codebooks, new.codes, new.scales,
                                             beam_size=beam_size, generator=generator)
        cbs = find_optimal_codebooks(ref_groups, new.codebooks.reshape(K, S, og * ig),
                                     codes.reshape(OG * IG, K)).reshape(K, S, og, ig)
        new = dataclasses.replace(new, codes=codes.to(new_scheme.code_dtype), codebooks=cbs)

    err = dequantize_weight(new, dtype=torch.float32) - W
    rel = float((err * err).sum() / torch.clamp((W * W).sum(), min=1e-12))
    return dataclasses.replace(new, bias=w.bias), rel


def requantize_params(params: dict, new_scheme: AqlmScheme, *, mode: str = "reference",
                      seed: int = 0, refine_iters: int = 2, beam_size: int = 2,
                      kmeans_iter: int = 50, verbose: bool = False) -> tuple[dict, float]:
    """Requantize every quantized projection of a params tree (loaded in
    reference mode) into ``new_scheme``, built in ``mode``.

    The unquantized leaves (embedding, norms, dense heads) are the input
    tree's own tensors, not copies, so a draft built from a target costs
    only its new codes and codebooks. Returns (new params, the worst
    relative weight MSE)."""
    from aqlm_tpu_torch.ops.runtime import QuantizedLinear

    generator = None
    worst = 0.0
    out = dict(params)
    new_layers = []
    for li, layer in enumerate(params["layers"]):
        new_layer = dict(layer)
        for name, q in layer.items():
            if not isinstance(q, QuantizedLinear):
                continue
            if q.codes is None:
                raise ValueError("requantize_params needs the canonical codes layout; load the "
                                 "model with mode='reference'")
            if generator is None:
                generator = torch.Generator(device=q.codes.device).manual_seed(seed)
            w = AqlmWeight(codes=q.codes, codebooks=q.codebooks, scales=q.scales, bias=q.bias,
                           scheme=q.scheme)
            w2, rel = requantize_weight(w, new_scheme, generator=generator,
                                        refine_iters=refine_iters, beam_size=beam_size,
                                        kmeans_iter=kmeans_iter)
            new_layer[name] = QuantizedLinear.from_aqlm(w2, mode=mode)
            worst = max(worst, rel)
            if verbose:
                print(f"layer {li} {name}: weight rel-MSE {rel:.4f}")
        new_layers.append(new_layer)
    out["layers"] = new_layers
    return out, worst
