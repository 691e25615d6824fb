"""1x16 -> 2xN additive codebook transcode (PyTorch counterpart of
``aqlm_tpu.ops.transcode``).

The 65536 rows of a 1x16 codebook (not the millions of weight groups) are
re-fit as a sum of two small codebooks,

    CB[c] ~= A[hi(c)] + B[lo(c)],

by usage-weighted alternating k-means over the rows, with a joint pass over
every (hi, lo) pair every five steps. The codes then transcode by table
lookup into a 2-codebook layout that the Kx8 codes kernels (K1, K2) serve:
2x8 (256-row books) or 2x7 (128 rows, ~2.0 bits resident). The error lives
in codebook space, weighted by code usage, and is returned so callers can
gate on it. Plain torch on the tensors' device: it is no kernel's work.
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.ops.dequant import AqlmWeight

__all__ = ["fit_additive_split", "transcode_1x16_to_2x8", "transcode_1x16_to_2xN"]


def _assign(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest center of each point (lowest index on ties). points [N, g], centers [S, g]."""
    d = ((points * points).sum(dim=1, keepdim=True) - 2.0 * points @ centers.t()
         + (centers * centers).sum(dim=1)[None, :])
    return d.argmin(dim=1)


def _update(points, assign, w, n_centers: int, old):
    """Usage-weighted cluster means; an empty cluster keeps its old center."""
    wsum = torch.zeros(n_centers, dtype=torch.float32, device=points.device).index_add_(
        0, assign, w)
    psum = torch.zeros((n_centers, points.shape[1]), dtype=torch.float32,
                       device=points.device).index_add_(0, assign, points * w[:, None])
    new = psum / torch.clamp(wsum, min=1e-12)[:, None]
    return torch.where((wsum > 0)[:, None], new, old)


def _initial_centers(n_rows: int, n_centers: int, seed: int, device) -> torch.Tensor:
    """The rows that seed A: ``n_centers`` distinct row indices drawn from
    ``seed`` (JAX draws them with ``jax.random.choice``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(n_rows, generator=gen, device=device)[:n_centers]


def _joint_assign(cb, A, B):
    """The exact argmin over every (hi, lo) pair, in chunks of codebook rows:
    the alternation alone stalls where each half's assignment is conditioned
    on the other's. The score is JAX's, M - 2 (pts.A + pts.B) (the doubling
    exact); a chunk's [rows, n, n] scores stay in the CPU's cache at 16 rows,
    and 2048 rows keep the card's launches few (the values do not depend on
    it)."""
    S16 = cb.shape[0]
    chunk = 2048 if cb.device.type == "cuda" else 16
    while S16 % chunk:
        chunk //= 2
    n = B.shape[0]
    M = ((A * A).sum(dim=1)[:, None] + (B * B).sum(dim=1)[None, :]
         + 2.0 * (A @ B.t()))  # ||A_a + B_b||^2, [n, n]
    hi = torch.empty(S16, dtype=torch.long, device=cb.device)
    lo = torch.empty(S16, dtype=torch.long, device=cb.device)
    for c0 in range(0, S16, chunk):
        pts = cb[c0:c0 + chunk]
        score = (pts @ A.t())[:, :, None] + (pts @ B.t())[:, None, :]
        score.mul_(-2.0).add_(M)
        flat = score.reshape(pts.shape[0], -1).argmin(dim=1)
        hi[c0:c0 + chunk] = flat // n
        lo[c0:c0 + chunk] = flat % n
    return hi, lo


def fit_additive_split(codebook: torch.Tensor, usage: torch.Tensor | None = None, *,
                       n_centers: int = 256, iters: int = 25, seed: int = 0):
    """Fit CB[c] ~= A[hi(c)] + B[lo(c)] by alternating weighted k-means.

    codebook [S16, g]; usage [S16] code-usage counts (None: all 1). Returns
    (A [n, g], B [n, g], hi [S16] uint8, lo [S16] uint8, rel_mse) with
    rel_mse = usage-weighted ||CB - A[hi] - B[lo]||^2 / ||CB||^2."""
    cb = codebook.float()
    S16, g = cb.shape
    w = torch.ones(S16, dtype=torch.float32, device=cb.device) if usage is None \
        else usage.float()
    w = torch.clamp(w, min=1e-6)  # unused codes still count a little (stability)

    A = cb[_initial_centers(S16, n_centers, seed, cb.device)]
    B = torch.zeros((n_centers, g), dtype=torch.float32, device=cb.device)  # starts at 0
    hi = _assign(cb, A)
    lo = torch.zeros(S16, dtype=torch.long, device=cb.device)
    for _ in range(max(1, iters // 5)):
        for _ in range(5):
            rA = cb - B[lo]
            hi = _assign(rA, A)
            A = _update(rA, hi, w, n_centers, A)
            rB = cb - A[hi]
            lo = _assign(rB, B)
            B = _update(rB, lo, w, n_centers, B)
        hi, lo = _joint_assign(cb, A, B)
        A = _update(cb - B[lo], hi, w, n_centers, A)
        B = _update(cb - A[hi], lo, w, n_centers, B)
    err = cb - A[hi] - B[lo]
    rel = (w[:, None] * err * err).sum() / torch.clamp((w[:, None] * cb * cb).sum(), min=1e-12)
    return A, B, hi.to(torch.uint8), lo.to(torch.uint8), float(rel)


def transcode_1x16_to_2xN(w: AqlmWeight, *, nbits: int = 8, iters: int = 25, seed: int = 0):
    """A 1x16 AqlmWeight as a 2-codebook additive layout of ``nbits`` each.

    Returns (the AqlmWeight in 2x``nbits``, the codebook rel-MSE). The codes
    map by table lookup (each 16-bit code's hi/lo pair); scales and bias are
    unchanged; the weight's relative MSE equals the usage-weighted codebook
    one (the dequant is linear in the codebook rows). nbits 8 (2x8) is the
    quality point, 7 (2x7) halves the codebook rows at a fit-error cost."""
    scheme = w.scheme
    if scheme.num_codebooks != 1 or scheme.nbits_per_codebook != 16:
        raise ValueError(f"transcode takes a 1x16 weight, got {scheme}")
    if scheme.out_group_size != 1:
        raise ValueError("transcode supports out_group_size == 1")
    if not 2 <= nbits <= 8:
        raise ValueError(f"nbits must lie in 2..8, got {nbits}")
    g = scheme.in_group_size
    cb = w.codebooks[0, :, 0, :].float()  # [65536, g]
    codes16 = w.codes[:, :, 0].long() & 0xFFFF  # [OUT, IG], int16 storage read unsigned
    usage = torch.bincount(codes16.reshape(-1), minlength=cb.shape[0]).float()
    A, B, hi, lo, rel = fit_additive_split(cb, usage, n_centers=2 ** nbits, iters=iters,
                                           seed=seed)
    new_codes = torch.stack([hi[codes16], lo[codes16]], dim=-1)  # [OUT, IG, 2] uint8
    new_cbs = torch.stack([A, B])[:, :, None, :]  # [2, 2^nbits, 1, g]
    out = AqlmWeight(codes=new_codes, codebooks=new_cbs.to(w.codebooks.dtype), scales=w.scales,
                     bias=w.bias, scheme=AqlmScheme(num_codebooks=2, nbits_per_codebook=nbits,
                                                    in_group_size=g, out_group_size=1))
    return out, rel


def transcode_1x16_to_2x8(w: AqlmWeight, *, iters: int = 25, seed: int = 0):
    """The 2x8 transcode (``transcode_1x16_to_2xN`` at nbits 8)."""
    return transcode_1x16_to_2xN(w, nbits=8, iters=iters, seed=seed)
