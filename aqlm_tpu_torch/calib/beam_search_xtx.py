"""Beam search over discrete codes minimizing ||X W_ref^T - X W_q^T||^2
(PyTorch counterpart of ``aqlm_tpu.calib.beam_search_xtx``).

Out groups are independent, so the search runs over all of them at once. It
visits the (input group, codebook) positions in ``steps_order``, scores every
codebook entry as the replacement at each, and keeps the ``beam_size`` best
joint hypotheses per out group. The carry is the JAX module's:
R = (W_ref - W_beam) @ XTX with a rank-g update per step, so a step costs
O(out * g * in) and not O(out * in^2). With one beam the update is taken in
place (the JAX array is rebuilt each step; the values are the same).

Ties: ``jax.lax.top_k`` keeps the lower index, so the k smallest here come
from a stable sort (one beam: ``argmin``, the first minimum). On the TPU this
is XLA, not Pallas; plain torch ops are its counterpart on the card. The JAX
module's out-group chunking and candidate blocking bound memory or work
around a v5e fault and change no value.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["beam_search_optimal_codes", "channelwise_squared_error"]

# candidates scored at once along the codebook axis by the L2 beam search
# (calib/beam_search_l2) when a codebook is larger: JAX's block width
_SCORE_S_BLOCK = 8192


def channelwise_squared_error(XTX: torch.Tensor, weight: torch.Tensor,
                              reference_weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel ||X w - X w_ref||^2."""
    resid = (weight - reference_weight).float()
    return ((resid @ XTX.float()) * resid).sum(dim=-1)


def _topk_smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries of each row, the lower
    index first among equal values."""
    if k == 1:
        idx = x.argmin(dim=-1, keepdim=True)
        return torch.gather(x, -1, idx), idx
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_optimal_codes(XTX: torch.Tensor, reference_weight: torch.Tensor,
                              codebooks: torch.Tensor, prev_codes: torch.Tensor,
                              scales: torch.Tensor | None, *, beam_size: int = 8,
                              steps_order=None):
    """Better codes for one weight matrix under the activation MSE.

    XTX [in, in]; reference_weight [out, in]; codebooks [K, S, og, g];
    prev_codes [OG, IG, K]; scales [OG], [OG, IG] or None; steps_order
    [IG*K, 2] (ig, k) visit order (natural order if None).
    Returns (codes [OG, IG, K] in prev_codes' dtype, final per-group losses [OG]).
    """
    K, S, og, g = codebooks.shape
    OG, IG, K2 = prev_codes.shape
    assert K2 == K
    out, in_features, B = OG * og, IG * g, beam_size
    dev = reference_weight.device
    XTX = XTX.float()
    W = reference_weight.float()
    cbs = codebooks.float()
    if scales is None:
        sc_full = torch.ones((OG, IG), dtype=torch.float32, device=dev)
    elif scales.ndim == 1:
        sc_full = scales.float().reshape(OG, 1).expand(OG, IG)
    else:
        sc_full = scales.float()

    codes0 = prev_codes.long()  # uint8/uint16 read unsigned
    flat = cbs.reshape(K, S, og * g)
    acc = None
    for k in range(K):
        part = flat[k][codes0[:, :, k].reshape(-1)]
        acc = part if acc is None else acc + part
    deq = (acc.reshape(OG, IG, og, g) * sc_full[:, :, None, None]).permute(0, 2, 1, 3)
    resid0 = W - deq.reshape(out, in_features)
    RXTX0 = resid0 @ XTX
    losses0 = (RXTX0 * resid0).sum(dim=-1).reshape(OG, og).sum(-1)

    beam_codes = codes0[None].expand(B, OG, IG, K).contiguous()
    beam_RXTX = RXTX0[None].expand(B, out, in_features).contiguous()
    del RXTX0, resid0
    beam_losses = losses0[None].expand(B, OG).contiguous()

    if steps_order is None:
        steps_order = np.stack([np.repeat(np.arange(IG), K), np.tile(np.arange(K), IG)], axis=1)
    steps_order = np.asarray(steps_order)
    dup_penalty = torch.where(torch.arange(B, device=dev) > 0, float("inf"), 0.0)
    no_penalty = torch.zeros(B, device=dev)
    rows = torch.arange(OG, device=dev)

    for step_i, (ig, k) in enumerate(steps_order.tolist()):
        sl = ig * g
        sc = sc_full[:, ig]
        XTX_cols = XTX[:, sl:sl + g]
        XTX_gg = XTX[sl:sl + g, sl:sl + g]
        cb = cbs[k]  # [S, og, g]
        prev_code = beam_codes[:, :, ig, k]  # [B, OG]
        prev_deq = cb[prev_code]  # [B, OG, og, g]
        RXTX_sl = beam_RXTX[:, :, sl:sl + g].reshape(B, OG, og, g)

        prev_x = torch.einsum("boyg,gh->boyh", prev_deq, XTX_gg)
        dwx = RXTX_sl + sc[None, :, None, None] * prev_x
        cand_norm = torch.einsum("syg,gh,syh->s", cb, XTX_gg, cb)
        old_norm = torch.einsum("boyh,boyh->bo", prev_x, prev_deq)
        prev_dot = torch.einsum("boyg,boyg->bo", prev_deq, dwx)
        penalty = dup_penalty if step_i == 0 else no_penalty

        base = (beam_losses + 2.0 * sc[None, :] * prev_dot - sc[None, :] ** 2 * old_norm).t()
        cand_dot = torch.einsum("boyg,syg->obs", dwx, cb)
        cand = (base[:, :, None] - 2.0 * sc[:, None, None] * cand_dot
                + (sc[:, None] ** 2)[:, :, None] * cand_norm[None, None, :]
                + penalty[None, :, None])
        vals, flat_idx = _topk_smallest(cand.reshape(OG, B * S), B)
        new_losses = vals.t().contiguous()  # [B, OG]
        flat_idx = flat_idx.t()
        src_beam = flat_idx // S
        new_code = flat_idx % S

        if B == 1:
            old_deq_src = prev_deq
            beam_codes[0, :, ig, k] = new_code[0]
        else:
            beam_codes = beam_codes[src_beam, rows[None, :]]  # [B, OG, IG, K]
            beam_codes[:, :, ig, k] = new_code
            old_deq_src = prev_deq[src_beam, rows[None, :]]
        delta = (cb[new_code] - old_deq_src) * sc[None, :, None, None]
        delta_rows = delta.reshape(B, out, g)
        update = torch.einsum("bog,ng->bon", delta_rows, XTX_cols)
        if B == 1:
            beam_RXTX.sub_(update)
        else:
            src_rows = src_beam.repeat_interleave(og, dim=1)  # [B, out]
            beam_RXTX = beam_RXTX[src_rows, torch.arange(out, device=dev)[None, :]] - update
        beam_losses = new_losses

    best = beam_losses.argmin(dim=0)  # [OG]
    final_codes = beam_codes[best, rows]
    final_losses = beam_losses[best, rows]
    return final_codes.to(prev_codes.dtype), final_losses
