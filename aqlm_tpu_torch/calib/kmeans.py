"""K-means for codebook initialization (PyTorch counterpart of
``aqlm_tpu.calib.kmeans``): ``fit_kmeans`` (residual k-means), ``_greedy_init``
(farthest point), ``find_nearest_cluster`` and the sort-based ``fit_kmeans_1d``.

The contract is the JAX module's: the assignment is argmax(x.c - 0.5||c||^2)
with ties to the lowest cluster index (``torch.argmax`` returns the first
maximum), empty clusters keep their centroid, and convergence is checked
every ``check_every`` iterations. The points are scored in chunks of
``chunk`` rows to bound the [chunk, k] score matrix. The JAX module's
8192-wide cluster blocking and row-packed gather work around a v5e fault and
compute the same values; the card needs neither.

The initial centroids are drawn with a ``torch.Generator`` where JAX draws
with ``jax.random`` (the two give other numbers from one seed);
``_fit_kmeans_from`` runs the fit from given centroids.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fit_kmeans", "find_nearest_cluster", "fit_kmeans_1d"]


def _take_rows_safe(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: the rows of ``table`` [k, d] at ``idx`` (JAX's row-packed
    gather avoids a v5e fault; on the card and the CPU a plain index)."""
    return table[idx.long()]


def _assign(data: torch.Tensor, clusters: torch.Tensor, chunk: int) -> torch.Tensor:
    """argmin_c ||x - c||^2 per point, as argmax(x.c - 0.5||c||^2), lowest index on ties."""
    half_sq = 0.5 * (clusters * clusters).sum(dim=1)
    out = torch.empty(data.shape[0], dtype=torch.long, device=data.device)
    for s in range(0, data.shape[0], chunk):
        scores = data[s:s + chunk] @ clusters.t() - half_sq[None, :]
        out[s:s + chunk] = scores.argmax(dim=1)
    return out


def _fit_kmeans_from(data: torch.Tensor, clusters0: torch.Tensor, *, max_iter: int = 100,
                     check_every: int = 10, rtol: float = 1e-6, atol: float = 1e-8,
                     chunk: int = 65536):
    """Lloyd iterations from the centroids ``clusters0`` (see ``fit_kmeans``)."""
    data = data.float()
    k = clusters0.shape[0]
    clusters = clusters0.float()
    counts_of = lambda idx: torch.bincount(idx, minlength=k).to(torch.float32)
    for i in range(max_iter):
        idx = _assign(data, clusters, chunk)
        sums = torch.zeros_like(clusters).index_add_(0, idx, data)
        counts = counts_of(idx)
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], clusters)
        converged = (i % check_every == check_every - 1) and bool(
            ((new - clusters).abs() <= atol + rtol * clusters.abs()).all())
        clusters = new
        if converged:
            break
    idx = _assign(data, clusters, chunk)
    return clusters, idx, clusters[idx]


def fit_kmeans(data: torch.Tensor, k: int, *, generator: torch.Generator | None = None,
               max_iter: int = 100, check_every: int = 10, rtol: float = 1e-6,
               atol: float = 1e-8, chunk: int = 65536, greedy_init: bool = False):
    """K-means on [nsamples, dim] data: (clusters [k, dim] f32, indices
    [nsamples] int64, restored [nsamples, dim]). The initial centroids are k
    distinct points drawn with ``generator`` (with repeats when nsamples <
    k), or the farthest-point init with ``greedy_init``."""
    data = data.float()
    n = data.shape[0]
    if greedy_init:
        clusters0 = _greedy_init(data, k)
    else:
        if n >= k:
            perm = torch.randperm(n, generator=generator, device=data.device)[:k]
        else:
            perm = torch.randint(0, n, (k,), generator=generator, device=data.device)
        clusters0 = data[perm]
    return _fit_kmeans_from(data, clusters0, max_iter=max_iter, check_every=check_every,
                            rtol=rtol, atol=atol, chunk=chunk)


def _greedy_init(data: torch.Tensor, k: int) -> torch.Tensor:
    """Farthest-point init: each centroid is the point farthest from those
    already chosen (the first is point 0)."""
    n, d = data.shape
    norms = (data * data).sum(dim=1)
    clusters = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    running_min = torch.full((n,), float("inf"), dtype=torch.float32, device=data.device)
    for i in range(k):
        pick = data[running_min.argmax()]
        dist = norms - 2.0 * (data @ pick) + (pick * pick).sum()
        clusters[i] = pick
        running_min = torch.minimum(running_min, dist)
    return clusters


def find_nearest_cluster(data: torch.Tensor, clusters: torch.Tensor, *, chunk: int = 65536):
    """(indices, restored) of each point's nearest cluster."""
    clusters = clusters.float()
    idx = _assign(data.float(), clusters, chunk)
    return idx, clusters[idx]


# ---------------------------------------------------------------------------
# sort-based 1-D k-means (for scale and codebook-value quantization)
# ---------------------------------------------------------------------------


def _border_indices(clusters: torch.Tensor, sorted_data: torch.Tensor) -> torch.Tensor:
    """[G, k+1] first index of each cluster in the sorted rows (midpoint search)."""
    mids = 0.5 * (clusters[:, 1:] + clusters[:, :-1])
    g = clusters.shape[0]
    inf = torch.full((g, 1), float("inf"), dtype=clusters.dtype, device=clusters.device)
    borders = torch.cat([-inf, mids, inf], dim=1)
    return torch.searchsorted(sorted_data.contiguous(), borders.contiguous(), side="left")


def _linspace_round(start: int, stop: int, num: int) -> np.ndarray:
    """round(linspace(start, stop, num)) as jnp computes it in f32: start * (1
    - t) + stop * t with t = i / (num - 1), the last point ``stop``."""
    if num == 1:
        return np.array([start], np.int64)
    div = num - 1
    t = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(start) * (np.float32(1) - t) + np.float32(stop) * t
    out = np.concatenate([out, np.array([stop], np.float32)])
    return np.round(out).astype(np.int64)


def fit_kmeans_1d(groupwise_data: torch.Tensor, k: int, *, max_iter: int = 100,
                  offset_rate: float = 0.0, rtol: float = 1e-6, atol: float = 1e-8):
    """Exact-EM 1-D k-means per row via sort + prefix sums. Input [G, n];
    returns (clusters [G, k], indices [G, n], restored [G, n])."""
    assert groupwise_data.ndim == 2
    data = groupwise_data.float()
    g, n = data.shape
    order = torch.argsort(data, dim=1, stable=True)
    sorted_data = torch.gather(data, 1, order)
    ranks_1based = torch.argsort(order, dim=1, stable=True) + 1
    cumsum = torch.cat([torch.zeros((g, 1), dtype=torch.float32, device=data.device),
                        torch.cumsum(sorted_data, dim=1)], dim=1)
    offset = int((n - 1) * offset_rate)
    init_idx = torch.from_numpy(_linspace_round(offset, n - 1 - offset, k)).to(data.device)
    clusters = sorted_data[:, init_idx]

    def em(c):
        borders = _border_indices(c, sorted_data)
        sums = torch.diff(torch.gather(cumsum, 1, borders), dim=1)
        counts = torch.diff(borders, dim=1)
        fallback = torch.gather(sorted_data, 1, borders[:, :-1].clamp(0, n - 1))
        return torch.where(counts > 0, sums / counts.clamp(min=1), fallback)

    for _ in range(max_iter):
        new = em(clusters)
        converged = bool(((new - clusters).abs() <= atol + rtol * clusters.abs()).all())
        clusters = new
        if converged:
            break

    borders = _border_indices(clusters, sorted_data)
    indices = torch.searchsorted(borders[:, 1:].contiguous(), ranks_1based.contiguous(),
                                 side="left")
    restored = torch.gather(clusters, 1, indices)
    return clusters, indices, restored
