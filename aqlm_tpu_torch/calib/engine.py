"""Per-layer calibration engine: XTX capture, k-means init, AMSGrad + beam
search alternation (PyTorch counterpart of ``aqlm_tpu.calib.engine``).

- ``XTXAccumulator`` keeps the running mean of X^T X as a Kahan-compensated
  f32 sum (the reference accumulates in float64).
- ``init_quantized_weight``: per-out-group (or per-group) row-norm scales and
  residual k-means over the codebooks.
- ``quantize_weight`` alternates ``steps_per_epoch`` AMSGrad updates of the
  codebooks and scales against the activation MSE with a beam-search sweep
  over the codes, with the same early-stopping rule. The MSE dequantizes
  through ``dequantize_weight``: on the card B13 in every forward and B14 in
  every backward (Kx8 schemes).

The AMSGrad step is optax's ``amsgrad(lr, b1=0, b2=0.95)``, written out: it
takes the maximum of the bias-corrected second moment, where
``torch.optim.Adam(amsgrad=True)`` takes it of the raw moment and corrects
afterwards (the two differ from the second step on).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from aqlm_tpu_torch.calib.beam_search_xtx import beam_search_optimal_codes
from aqlm_tpu_torch.calib.kmeans import find_nearest_cluster, fit_kmeans, fit_kmeans_1d
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops.dequant import AqlmWeight, dequantize_weight
from aqlm_tpu_torch.ops.runtime import not_ported

__all__ = ["CalibConfig", "XTXAccumulator", "init_quantized_weight", "compute_mse",
           "quantize_weight", "effective_codebooks", "effective_scales",
           "quantize_values_1d_st"]

EPS = 1e-9


@dataclasses.dataclass
class CalibConfig:
    """Hyperparameters of per-layer AQ calibration (the reference CLI's names
    and defaults)."""

    lr: float = 1e-4
    beam_size: int = 1
    max_epochs: int = 1000
    steps_per_epoch: int = 100
    relative_mse_tolerance: float | None = 0.01
    init_max_iter: int = 100
    init_max_points_per_centroid: int | None = None
    seed: int = 0
    verbose: bool = False
    scale_nbits: int = 0  # 0 = one scale per out group; >0 = per (out, in) group
    codebook_value_nbits: int = 16  # <16 = 1-D-k-means-quantize the codebook values
    codebook_value_num_groups: int = 1


# ---------------------------------------------------------------------------
# XTX accumulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class XTXAccumulator:
    """Running mean of X^T X with a Kahan-compensated f32 sum: after any
    number of ``add`` calls, ``mean`` is sum_i x_i x_i^T / nsamples."""

    total: torch.Tensor  # [in, in] f32
    comp: torch.Tensor  # [in, in] f32, the compensation term
    nsamples: int

    @staticmethod
    def zeros(in_features: int, device=None) -> "XTXAccumulator":
        z = torch.zeros((in_features, in_features), dtype=torch.float32, device=device)
        return XTXAccumulator(total=z, comp=z.clone(), nsamples=0)

    def add(self, inputs: torch.Tensor) -> "XTXAccumulator":
        """inputs: [..., in_features], one calibration minibatch."""
        x = inputs.reshape(-1, inputs.shape[-1]).float()
        y = x.t() @ x - self.comp
        t = self.total + y
        comp = (t - self.total) - y
        return XTXAccumulator(total=t, comp=comp, nsamples=self.nsamples + x.shape[0])

    @property
    def mean(self) -> torch.Tensor:
        return self.total / max(self.nsamples, 1)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def quantize_values_1d_st(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """1-D-k-means-quantize each row of ``values`` with a straight-through gradient."""
    _, _, restored = fit_kmeans_1d(values.detach(), 2 ** nbits)
    return restored + (values - values.detach())


def effective_codebooks(codebooks: torch.Tensor, config: CalibConfig) -> torch.Tensor:
    """Second-level codebook-value quantization."""
    if config.codebook_value_nbits >= 16:
        return codebooks
    K, S, og, ig = codebooks.shape
    vg = config.codebook_value_num_groups
    rows = codebooks.reshape(K, vg, S // vg, og, ig).permute(0, 1, 3, 4, 2).reshape(-1, S // vg)
    rows = quantize_values_1d_st(rows, config.codebook_value_nbits)
    return rows.reshape(K, vg, og, ig, S // vg).permute(0, 1, 4, 2, 3).reshape(K, S, og, ig)


def effective_scales(scales: torch.Tensor, config: CalibConfig) -> torch.Tensor:
    """Quantized group-wise scales with a straight-through gradient; lossless
    when 2^scale_nbits >= num_in_groups."""
    if scales.ndim == 1 or config.scale_nbits >= 16:
        return scales
    if 2 ** config.scale_nbits >= scales.shape[1]:
        return scales
    return quantize_values_1d_st(scales, config.scale_nbits)


def init_quantized_weight(reference_weight: torch.Tensor, scheme: AqlmScheme, *,
                          generator: torch.Generator | None = None, max_iter: int = 100,
                          max_points_per_centroid: int | None = None,
                          scale_nbits: int = 0) -> AqlmWeight:
    """Scales (the row norm per out group, or per (out, in) group, plus eps)
    and residual k-means codebooks, fit one codebook at a time on the
    scale-normalized weight. ``generator`` (on the weight's device) draws
    the k-means init and the point subsets."""
    out_f, in_f = reference_weight.shape
    scheme.check_features(out_f, in_f)
    og, ig = scheme.out_group_size, scheme.in_group_size
    n_og, n_ig = out_f // og, in_f // ig
    w = reference_weight.float()
    groups = w.reshape(n_og, og, n_ig, ig).transpose(1, 2)  # [n_og, n_ig, og, ig]
    if scale_nbits > 0:
        scales = (groups.reshape(n_og, n_ig, -1) ** 2).sum(dim=-1).sqrt() + EPS
        normalized = groups / scales[:, :, None, None]
    else:
        scales = (groups.reshape(n_og, -1) ** 2).sum(dim=-1).sqrt() + EPS
        normalized = groups / scales[:, None, None, None]

    residue = normalized.reshape(n_og * n_ig, og * ig)
    codes_list, cb_list = [], []
    for _ in range(scheme.num_codebooks):
        if max_points_per_centroid is not None:
            n_pts = min(max_points_per_centroid * scheme.codebook_size, residue.shape[0])
            sel = torch.randperm(residue.shape[0], generator=generator, device=residue.device)[:n_pts]
            fit_data = residue[sel]
        else:
            fit_data = residue
        clusters, _, _ = fit_kmeans(fit_data, scheme.codebook_size, generator=generator,
                                    max_iter=max_iter)
        idx, restored = find_nearest_cluster(residue, clusters)
        residue = residue - restored
        codes_list.append(idx.reshape(n_og, n_ig, 1))
        cb_list.append(clusters.reshape(1, scheme.codebook_size, og, ig))
    codes = torch.cat(codes_list, dim=-1).to(scheme.code_dtype)
    return AqlmWeight(codes=codes, codebooks=torch.cat(cb_list, dim=0), scales=scales, bias=None,
                      scheme=scheme)


# ---------------------------------------------------------------------------
# MSE + alternating optimization
# ---------------------------------------------------------------------------


def compute_mse(weight: AqlmWeight, reference_weight: torch.Tensor,
                XTX: torch.Tensor) -> torch.Tensor:
    """Activation MSE = sum((dW @ XTX) * dW) / out_features; differentiable
    in the codebooks and scales."""
    dw = dequantize_weight(weight, dtype=torch.float32) - reference_weight.float()
    return ((dw @ XTX.float()) * dw).sum() / weight.out_features


class _AMSGrad:
    """optax.amsgrad(lr, b1, b2, eps=1e-8) on a list of tensors, in place:
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; nu_max = max(nu_max,
    nu / (1 - b2^t)); p -= lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)."""

    def __init__(self, params, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.nu_max = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        # the bias corrections in f32, as optax takes them (exact as Python floats)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            mu_hat = self.mu[i] / bc1
            nu_hat = self.nu[i] / bc2
            self.nu_max[i] = torch.maximum(self.nu_max[i], nu_hat)
            update = -self.lr * (mu_hat / (self.nu_max[i].sqrt() + self.eps))
            p.add_(update)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quantize_weight(reference_weight: torch.Tensor, XTX: torch.Tensor, scheme: AqlmScheme,
                    config: CalibConfig = CalibConfig(), *, mesh=None) -> tuple[AqlmWeight, dict]:
    """Init, then AMSGrad epochs alternating with beam-search sweeps.

    Returns (quantized weight, stats): ``loss_history`` (each epoch's first
    loss), ``init_mse`` and ``final_mse``, ``adam_steps``, and ``seconds``
    by part (init, adam, beam)."""
    if mesh is not None:
        raise not_ported("out-group-sharded beam search over a mesh", "A14")
    dev = reference_weight.device
    rng = np.random.RandomState(config.seed)
    seconds = {"init": 0.0, "adam": 0.0, "beam": 0.0}
    t0 = time.perf_counter()
    weight = init_quantized_weight(
        reference_weight, scheme,
        generator=torch.Generator(device=dev).manual_seed(config.seed),
        max_iter=config.init_max_iter,
        max_points_per_centroid=config.init_max_points_per_centroid,
        scale_nbits=config.scale_nbits,
    )
    _sync(dev)
    seconds["init"] = time.perf_counter() - t0
    if config.verbose:
        print(f"init (residual kmeans) {seconds['init']:.1f}s", flush=True)
    ref_w = reference_weight.float()
    codes = weight.codes
    codebooks = weight.codebooks.clone().requires_grad_(True)
    scales = weight.scales.clone().requires_grad_(True)
    opt = _AMSGrad([codebooks, scales], config.lr, b1=0.0, b2=0.95)

    def loss_fn():
        w = AqlmWeight(codes=codes, codebooks=effective_codebooks(codebooks, config),
                       scales=effective_scales(scales, config), bias=None, scheme=scheme)
        return compute_mse(w, ref_w, XTX)

    n_steps = (reference_weight.shape[1] // scheme.in_group_size) * scheme.num_codebooks
    previous_best = float("inf")
    history = []
    adam_steps = 0
    for epoch in range(config.max_epochs):
        t0 = time.perf_counter()
        losses = []
        for _ in range(config.steps_per_epoch):
            loss = loss_fn()
            grads = torch.autograd.grad(loss, [codebooks, scales])
            opt.step(grads)
            losses.append(loss.detach())
            adam_steps += 1
        first_loss = float(losses[0])
        seconds["adam"] += time.perf_counter() - t0
        if not np.isfinite(first_loss):
            raise ValueError(f"quantization loss is {first_loss}")
        history.append(first_loss)
        if config.verbose:
            print(f"epoch={epoch} first_loss={first_loss:.10f} "
                  f"(adam {time.perf_counter() - t0:.1f}s)", flush=True)
        if config.relative_mse_tolerance is not None:
            if first_loss / previous_best > (1.0 - config.relative_mse_tolerance):
                break
            previous_best = min(previous_best, first_loss)

        # shuffled (in_group, codebook) visit order, numpy's RandomState as in aqlm_tpu
        order = np.stack([
            np.repeat(rng.permutation(n_steps // scheme.num_codebooks), scheme.num_codebooks),
            np.concatenate([rng.permutation(scheme.num_codebooks)
                            for _ in range(n_steps // scheme.num_codebooks)]),
        ], axis=1).astype(np.int32)
        t0 = time.perf_counter()
        with torch.no_grad():
            codes, _ = beam_search_optimal_codes(
                XTX, reference_weight, effective_codebooks(codebooks, config), codes,
                effective_scales(scales, config), beam_size=config.beam_size,
                steps_order=order)
        _sync(dev)
        seconds["beam"] += time.perf_counter() - t0
        if config.verbose:
            print(f"epoch={epoch} beam sweep {seconds['beam']:.1f}s", flush=True)

    with torch.no_grad():
        final = AqlmWeight(codes=codes, codebooks=effective_codebooks(codebooks, config).detach(),
                           scales=effective_scales(scales, config).detach(), bias=None,
                           scheme=scheme)
        final_mse = float(compute_mse(final, reference_weight, XTX))
    # the first Adam step's loss is the MSE at the k-means init
    return final, {"loss_history": history, "init_mse": history[0] if history else None,
                   "final_mse": final_mse,
                   "adam_steps": adam_steps, "seconds": seconds}
