"""Beam search minimizing ||W_ref - W_q||^2 over codes, PV-tuning's V step
(PyTorch counterpart of ``aqlm_tpu.calib.beam_search_l2``).

Every (out group, in group) tile is an independent group whose
``num_codebooks`` codes are re-optimized by a beam sweep over the codebooks,
under PV-tuning's constraints:

- ``stochastic_rounding_tau``: a random pick between adjacent-ranked
  candidates;
- ``force_update``: the returned code differs from the input;
- ``max_update_fraction``: only the top fraction of groups (by residual
  norm) may change;
- ``code_selection_temperature``: that fraction sampled (Gumbel top-k)
  instead of taken by norm;
- ``trust_ratio``: changes admitted in order of importance while their
  cumulative norm stays within trust_ratio * ||W_prev||.

Ties go to the lower index, as ``jax.lax.top_k`` breaks them: the smallest
scores come from a stable sort (one candidate: ``argmin``, the first
minimum), the largest norms from a stable descending sort. Randomness comes
from an explicit ``torch.Generator`` (other numbers than JAX's key); without
``stochastic_rounding_tau`` and ``code_selection_temperature`` none is drawn
and the codes are JAX's. Groups are scored in chunks of about 2^25 score
elements and, past ``_SCORE_S_BLOCK`` candidates, in blocks of the codebook
merged by (score, index), which gives the one-pass selection. On the TPU this
is XLA, not Pallas; plain torch ops are its counterpart on the card.
"""

from __future__ import annotations


import torch

from aqlm_tpu_torch.calib import beam_search_xtx
from aqlm_tpu_torch.calib.kmeans import _take_rows_safe

__all__ = ["beam_search_optimal_codes_l2", "find_optimal_codebooks"]


def _dequant_groups(codes: torch.Tensor, flat_cbs: torch.Tensor, S: int) -> torch.Tensor:
    """codes [G, K], flat_cbs [K*S, gsz] -> [G, gsz], the sum over codebooks."""
    acc = None
    for k in range(codes.shape[1]):
        part = _take_rows_safe(flat_cbs[k * S:(k + 1) * S], codes[:, k])
        acc = part if acc is None else acc + part
    return acc


def _smallest(vals: torch.Tensor, idx: torch.Tensor, kb: int):
    """The ``kb`` smallest (value, index) pairs of each row, ordered by value,
    then index."""
    order = torch.sort(idx, dim=-1, stable=True).indices
    vals, idx = torch.gather(vals, -1, order), torch.gather(idx, -1, order)
    order = torch.sort(vals, dim=-1, stable=True).indices[..., :kb]
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def _topk_scores(rp, rn, cb_k, norms_k, penalty, kb: int):
    """The ``kb`` best (score, flat index b*S + s) of each group's B x S
    candidates; score = ||res_plus - c||^2 + penalty[b]."""
    gc, B, _ = rp.shape
    S = cb_k.shape[0]

    def scores_of(cb_b, norms_b):
        dots = torch.einsum("gbd,sd->gbs", rp, cb_b)
        return rn[:, :, None] - 2.0 * dots + norms_b[None, None, :] + penalty[None, :, None]

    sb = beam_search_xtx._SCORE_S_BLOCK
    if S <= sb:
        scores = scores_of(cb_k, norms_k).reshape(gc, B * S)
        if kb == 1:
            idx = scores.argmin(dim=-1, keepdim=True)
            return torch.gather(scores, -1, idx), idx
        vals, idx = torch.sort(scores, dim=-1, stable=True)
        return vals[:, :kb], idx[:, :kb]
    # codebook blocks of sb candidates, each block's best merged into the carry
    vals = torch.full((gc, 0), float("inf"), device=rp.device)
    idx = torch.zeros((gc, 0), dtype=torch.long, device=rp.device)
    beams = torch.arange(B, device=rp.device)[:, None] * S
    for base in range(0, S, sb):
        n = min(sb, S - base)
        blk = scores_of(cb_k[base:base + n], norms_k[base:base + n]).reshape(gc, B * n)
        flat = (beams + base + torch.arange(n, device=rp.device)[None, :]).reshape(-1)
        bv, bi = _smallest(blk, flat[None, :].expand(gc, -1), kb)
        vals, idx = _smallest(torch.cat([vals, bv], 1), torch.cat([idx, bi], 1), kb)
    return vals, idx


def _beam_update_codes(ref: torch.Tensor, cbs: torch.Tensor, codes: torch.Tensor, *,
                       beam_size: int, stochastic_rounding_tau: float, force_update: bool,
                       dim_order: list, generator: torch.Generator | None,
                       group_chunk: int) -> torch.Tensor:
    """Beam sweep over the codebooks (in ``dim_order``) for every group:
    ref [G, gsz] unscaled, cbs [K, S, gsz], codes [G, K] -> new codes [G, K]."""
    K, S, gsz = cbs.shape
    G = ref.shape[0]
    dev = ref.device
    B = beam_size
    if force_update or stochastic_rounding_tau > 0:
        B = max(B, 2)
    flat_cbs = cbs.reshape(K * S, gsz)
    cb_norms = (cbs * cbs).sum(dim=-1)  # [K, S]

    beam_codes = codes[:, None, :].expand(G, B, K).clone()
    residue = (ref - _dequant_groups(codes, flat_cbs, S))[:, None, :].expand(G, B, gsz)
    kb = B + (1 if stochastic_rounding_tau > 0 else 0)
    dup = torch.where(torch.arange(B, device=dev) > 0, float("inf"), 0.0)
    no_dup = torch.zeros(B, device=dev)

    for step_i, k in enumerate(dim_order):
        cb_k = cbs[k]
        codes_k = beam_codes[:, :, k]  # [G, B]
        res_plus = residue + cb_k[codes_k]  # codebook k's contribution added back
        res_norms = (res_plus * res_plus).sum(dim=-1)
        penalty = dup if step_i == 0 else no_dup
        parts = [_topk_scores(res_plus[s:s + group_chunk], res_norms[s:s + group_chunk],
                              cb_k, cb_norms[k], penalty, kb) for s in range(0, G, group_chunk)]
        vals = torch.cat([p[0] for p in parts])
        flat_idx = torch.cat([p[1] for p in parts])

        if stochastic_rounding_tau > 0:
            # a random choice between adjacent-ranked candidates
            errors = torch.sqrt(torch.clamp(vals, min=0.0))
            w = torch.pow(errors / torch.clamp(errors.sum(-1, keepdim=True), min=1e-30),
                          -1.0 / stochastic_rounding_tau)
            keep_prob = w[:, :-1] / (w[:, :-1] + w[:, 1:])
            keep_prob = torch.where(torch.isinf(w[:, :-1]), 1.0, keep_prob)
            u = torch.rand(keep_prob.shape, generator=generator, device=dev)
            flat_idx = torch.where(u <= keep_prob, flat_idx[:, :-1], flat_idx[:, 1:])

        flat_idx = flat_idx[:, :B]
        src = flat_idx // S
        new_code = flat_idx % S
        beam_codes = torch.gather(beam_codes, 1, src[:, :, None].expand(G, B, K)).clone()
        beam_codes[:, :, k] = new_code
        residue = torch.gather(res_plus, 1, src[:, :, None].expand(G, B, gsz)) - cb_k[new_code]

    if force_update:
        best, second = beam_codes[:, 0, :], beam_codes[:, 1, :]
        changed = (best != codes).any(dim=-1, keepdim=True)
        return torch.where(changed, best, second)
    return beam_codes[:, 0, :]


def _top_groups(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the ``n`` largest scores, largest first, ties to the lower index."""
    return torch.sort(scores, descending=True, stable=True).indices[:n]


def beam_search_optimal_codes_l2(reference_weight: torch.Tensor, codebooks: torch.Tensor,
                                 prev_codes: torch.Tensor, scales: torch.Tensor | None, *,
                                 beam_size: int = 1, stochastic_rounding_tau: float = 0.0,
                                 force_update: bool = False, max_update_fraction: float = 1.0,
                                 code_selection_temperature: float = 0.0,
                                 trust_ratio: float | None = None, dim_order=None,
                                 generator: torch.Generator | None = None,
                                 group_chunk: int | None = None) -> torch.Tensor:
    """New codes [OG, IG, K] (``prev_codes``' dtype) for reference_weight
    [out, in] under the constraints above; codebooks [K, S, og, ig],
    prev_codes [OG, IG, K], scales [OG], [OG, IG] or None; dim_order the
    codebook visit order (natural if None); ``generator`` on the weight's
    device, drawn from only under stochastic rounding or a temperature."""
    assert 0 < max_update_fraction <= 1
    K, S, ogs, igs = codebooks.shape
    OG, IG, K2 = prev_codes.shape
    assert K2 == K
    dev = reference_weight.device
    if group_chunk is None:
        # ~2^25 score elements a chunk
        b_eff = max(beam_size, 2 if (force_update or stochastic_rounding_tau > 0) else 1)
        group_chunk = max(512, 2 ** 25 // max(b_eff * S, 1))
    dim_order = list(range(K)) if dim_order is None else [int(k) for k in dim_order]

    groups = reference_weight.float().reshape(OG, ogs, IG, igs).permute(0, 2, 1, 3)
    if scales is not None:
        sc2 = (scales.float().reshape(OG, 1).expand(OG, IG) if scales.ndim == 1
               else scales.float())
        groups = groups / sc2[:, :, None, None]
    G = OG * IG
    ref = groups.reshape(G, ogs * igs)
    flat_codes = prev_codes.reshape(G, K).long()  # uint8/uint16 read unsigned
    cbs = codebooks.reshape(K, S, ogs * igs).float()
    flat_cbs = cbs.reshape(K * S, ogs * igs)
    update = dict(beam_size=beam_size, stochastic_rounding_tau=stochastic_rounding_tau,
                  force_update=force_update, dim_order=dim_order, generator=generator)

    if max_update_fraction < 1 or trust_ratio is not None:
        deq_prev = _dequant_groups(flat_codes, flat_cbs, S)  # unscaled [G, gsz]
        # the groups' squared residual norms on the scaled weights
        scale_sq = (torch.ones(G, device=dev) if scales is None else (sc2 ** 2).reshape(G))
        diff_norms = ((ref - deq_prev) ** 2).sum(dim=-1) * scale_sq
        n_update = int(-(-max_update_fraction * G // 1))  # ceil
        if code_selection_temperature > 0:
            # Gumbel top-k: sampling without replacement by norm^(0.5 / temperature)
            logits = (0.5 / code_selection_temperature) * torch.log(
                torch.clamp(diff_norms, min=1e-30))
            u = torch.rand((G,), generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
            sel = _top_groups(logits + gumbel, n_update)
        else:
            sel = _top_groups(diff_norms, n_update)  # most important first
        upd = _beam_update_codes(ref[sel], cbs, flat_codes[sel],
                                 group_chunk=min(group_chunk, n_update), **update)
        new_flat = flat_codes.clone()
        new_flat[sel] = upd
    else:
        new_flat = _beam_update_codes(ref, cbs, flat_codes, group_chunk=min(group_chunk, G),
                                      **update)

    if trust_ratio is not None:
        # admit changes most important first while the cumulative change norm
        # stays within trust_ratio * ||W_prev|| (norms on the scaled weights)
        deq_new = _dequant_groups(new_flat, flat_cbs, S)
        change_norms = ((deq_new - deq_prev) ** 2).sum(dim=-1) * scale_sq
        cum = torch.sqrt(torch.cumsum(change_norms[sel], dim=0))
        prev_norm = torch.sqrt(((deq_prev ** 2) * scale_sq[:, None]).sum())
        n_selected = 1 + torch.searchsorted(cum, (trust_ratio * prev_norm).reshape(1))
        admit = torch.arange(n_update, device=dev) < n_selected
        keep = torch.where(admit[:, None], new_flat[sel], flat_codes[sel])
        new_flat = flat_codes.clone()
        new_flat[sel] = keep

    return new_flat.reshape(OG, IG, K).to(prev_codes.dtype)


def find_optimal_codebooks(reference: torch.Tensor, codebooks: torch.Tensor,
                           codes: torch.Tensor) -> torch.Tensor:
    """Least-squares codebook refit from the codes' co-occurrence:
    reference [G, gsz], codebooks [K, S, gsz], codes [G, K] -> [K, S, gsz].
    The minimum-norm solution with JAX's ``lstsq`` cut-off (singular values
    below eps * K*S of the largest count as zero), from the pseudo-inverse."""
    K, S, gsz = codebooks.shape
    G = codes.shape[0]
    dev = reference.device
    flat = (codes.long() + (torch.arange(K, device=dev) * S)[None, :]).reshape(-1)
    rows = torch.arange(G, device=dev).repeat_interleave(K)
    onehot = torch.zeros((G, K * S), device=dev).index_put_((rows, flat), torch.ones_like(
        flat, dtype=torch.float32), accumulate=True)
    cooc = onehot.t() @ onehot
    rhs = onehot.t() @ reference.float()
    diag = torch.clamp(torch.diagonal(cooc), min=1.0)
    eye = torch.arange(K * S, device=dev)
    cooc[eye, eye] = diag
    rcond = torch.finfo(torch.float32).eps * K * S
    sol = torch.linalg.pinv(cooc, rtol=rcond) @ rhs
    return sol.reshape(K, S, gsz)
