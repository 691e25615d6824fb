"""Speculative decoding: a small draft model proposes k tokens, the target
verifies them in ONE forward (PyTorch counterpart of
``aqlm_tpu.serve.speculative``).

Verification is exact in both modes:

- temperature 0 (greedy): the emitted tokens are the target's own greedy
  decode (the longest prefix of proposals the target's argmax agrees with,
  then the target's argmax at the first disagreement);
- temperature > 0: Leviathan et al. 2023's accept/resample rule (accept
  d_i with probability min(1, p(d_i)/q(d_i)), resample the first rejection
  from normalize(max(p - q, 0))), whose output is distributed as target
  sampling. p and q are the temperature/top-k/top-p-filtered distributions
  of ``serve.sampler.filter_logits``.

Randomness comes from a ``torch.Generator``; its numbers differ from JAX's,
so only greedy decoding matches ``aqlm_tpu`` token for token. Draws use the
exponential race (``argmax(p / E)``, E ~ Exp(1)), which samples p as
``torch.multinomial`` does without reading anything back to the host.

Cache discipline: both models keep stacked KV caches, updated in place.
Rejected proposals leave stale rows past the accepted offset; the causal
mask hides them and the next round overwrites them, so nothing is rolled
back.
"""

from __future__ import annotations

import numpy as np
import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.serve.sampler import filter_logits

__all__ = ["SpeculativeDecoder", "speculative_accept", "batched_accept", "draft_chunk",
           "spec_round"]


def categorical(probs: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row of ``probs`` [..., V] (rows need not sum to 1; zero
    entries are never drawn): int64 [...]."""
    race = torch.empty_like(probs, dtype=torch.float32).exponential_(generator=generator)
    race.clamp_(min=torch.finfo(torch.float32).tiny)  # 0 / 0 would win the argmax
    return torch.argmax(probs.float() / race, dim=-1)


def _leading_true(mask: torch.Tensor) -> torch.Tensor:
    """The number of leading True entries along the last axis: int64 [...]."""
    return mask.long().cumprod(dim=-1).sum(dim=-1)


def speculative_accept(p_probs: torch.Tensor, q_probs: torch.Tensor, draft_toks: torch.Tensor,
                       generator: torch.Generator | None = None):
    """Leviathan accept/resample on filtered distributions.

    p_probs [..., k+1, V]: the target's distribution at each scored position;
    q_probs [..., k, V]: the draft distribution each proposal was drawn from;
    draft_toks [..., k]. Returns (n_accept, bonus), int64 [...]: proposal i
    is accepted when u * q(d_i) < p(d_i) (u ~ U[0, 1); robust to q == 0);
    the first rejection resamples from normalize(max(p - q, 0)), and when
    every proposal is accepted the bonus comes from p at row k. A residual
    that sums to at most 1e-9 (p == q) falls back to p itself."""
    k = draft_toks.shape[-1]
    d = draft_toks.long()[..., None]
    p_tok = p_probs[..., :k, :].gather(-1, d)[..., 0]
    q_tok = q_probs.gather(-1, d)[..., 0]
    u = torch.rand(p_tok.shape, generator=generator, device=p_probs.device)
    n_accept = _leading_true(u * q_tok < p_tok)
    # the residual at the first rejected position (rows padded so index k is valid)
    q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[..., :1, :])], dim=-2)
    at = n_accept[..., None, None].expand(*n_accept.shape, 1, p_probs.shape[-1])
    p_n = p_probs.gather(-2, at)[..., 0, :]
    residual = torch.clamp(p_n - q_pad.gather(-2, at)[..., 0, :], min=0.0)
    safe = torch.where(residual.sum(dim=-1, keepdim=True) > 1e-9, residual, p_n)
    return n_accept, categorical(safe, generator)


def batched_accept(logits: torch.Tensor, q_rows: torch.Tensor | None, draft_toks: torch.Tensor,
                   temps: torch.Tensor, top_ps: torch.Tensor, generator: torch.Generator | None,
                   *, k: int, top_k: int = 0, any_sampling: bool | None = None):
    """Accept over slots: logits [b, k+1, V] (the target's verify forward),
    q_rows [b, k, V] (the draft distributions; None when no row samples),
    draft_toks [b, k]. Temperature-0 rows take the greedy agree-prefix rule
    on the f32 logits' argmax, sampled rows the Leviathan rule. Returns
    (n_acc [b], bonus [b], lp_d [b, k], lp_bonus [b]): lp_* are the raw
    ``log_softmax`` logprobs of the proposals and of the bonus token.
    ``any_sampling`` as in ``sample_tokens`` (None reads the temperatures)."""
    lg = logits.float()
    b, _, v = lg.shape
    d = draft_toks.long()
    preds = torch.argmax(lg, dim=-1)  # [b, k+1]
    n_acc = _leading_true(preds[:, :k] == d)
    bonus = preds.gather(1, n_acc[:, None])[:, 0]
    if any_sampling is None:
        any_sampling = bool((temps > 0).any())
    if any_sampling:
        scaled = filter_logits(lg.reshape(b * (k + 1), v), temps.repeat_interleave(k + 1),
                               top_ps.repeat_interleave(k + 1), top_k).reshape(b, k + 1, v)
        n_s, bonus_s = speculative_accept(torch.softmax(scaled, dim=-1), q_rows, d, generator)
        sampled = temps > 0
        n_acc = torch.where(sampled, n_s, n_acc)
        bonus = torch.where(sampled, bonus_s, bonus)
    # raw model logprobs of the emitted chunk: d_i from row i-1, the bonus from row n_acc
    logp = torch.log_softmax(lg, dim=-1)
    lp_d = logp[:, :k].gather(-1, d[..., None])[..., 0]
    lp_bonus = logp.gather(1, n_acc[:, None, None].expand(b, 1, v))[:, 0].gather(
        -1, bonus[:, None])[:, 0]
    return n_acc, bonus, lp_d, lp_bonus


def draft_chunk(params: dict, cfg: llama.ModelConfig, cache, prev: torch.Tensor,
                last: torch.Tensor, offsets: torch.Tensor, temps: torch.Tensor,
                top_ps: torch.Tensor, *, k: int, top_k: int = 0,
                generator: torch.Generator | None = None, any_sampling: bool = False,
                use_flash_decode: bool | None = None):
    """k draft tokens over rows [b], one single-token forward each, on the
    device with no host sync: (draft_toks [b, k] int64, q_rows [b, k, V] f32
    or None when no row samples).

    The chunk starts one position EARLY: its first forward re-processes
    ``prev`` (the token at offsets-1) and its continuation is forced to
    ``last``. When a verify round accepts all k proposals, the k-th
    proposal's KV was never written (the steps write offsets..offsets+k-1
    for [last, d_1..d_{k-1}]); the next chunk's first step fills that row.
    Re-writing an already-correct row changes nothing."""
    tok, off = prev, offsets - 1
    toks, qs = [], []
    for i in range(k + 1):
        logits, _ = forward_stacked(params, cfg, tok[:, None], cache=cache, cache_offset=off,
                                    use_flash_decode=use_flash_decode)
        off = off + 1
        if i == 0:  # the forced continuation: only the row this step wrote counts
            tok = last
            continue
        lg = logits[:, -1].float()
        tok = torch.argmax(lg, dim=-1)
        if any_sampling:
            q = torch.softmax(filter_logits(lg, temps, top_ps, top_k), dim=-1)
            tok = torch.where(temps > 0, categorical(q, generator), tok)
            qs.append(q)
        toks.append(tok)
    return torch.stack(toks, dim=1), (torch.stack(qs, dim=1) if qs else None)


def spec_round(tparams: dict, tcfg: llama.ModelConfig, tcache, dparams: dict,
               dcfg: llama.ModelConfig, dcache, prev: torch.Tensor, last: torch.Tensor,
               offsets: torch.Tensor, host_offsets: list, temps: torch.Tensor,
               top_ps: torch.Tensor, *, k: int, top_k: int = 0,
               generator: torch.Generator | None = None, any_sampling: bool = False,
               use_flash_decode: bool | None = None):
    """One draft-and-verify round over rows [b], all on the device: the k+1
    draft forwards (``draft_chunk``), ONE [b, k+1] target forward over
    [last, d_1..d_k] at ``offsets`` (``host_offsets``: the same offsets as
    host ints, so its cache writes read nothing back), then
    ``batched_accept``. Returns (draft_toks, n_acc, bonus, lp_d, lp_bonus)."""
    draft_toks, q_rows = draft_chunk(dparams, dcfg, dcache, prev, last, offsets, temps, top_ps,
                                     k=k, top_k=top_k, generator=generator,
                                     any_sampling=any_sampling, use_flash_decode=use_flash_decode)
    ids = torch.cat([last[:, None], draft_toks], dim=1)
    logits, _ = forward_stacked(tparams, tcfg, ids, cache=tcache, cache_offset=offsets,
                                use_flash_decode=use_flash_decode, host_offsets=host_offsets)
    return (draft_toks,) + batched_accept(logits, q_rows, draft_toks, temps, top_ps, generator,
                                          k=k, top_k=top_k, any_sampling=any_sampling)


class SpeculativeDecoder:
    """Draft-and-verify decoding for batch-1 requests.

    Target and draft params are any runtime mode (dense, int8, int4, codes)
    on ``device`` (None = the card); they are stacked at construction. ``k``
    draft tokens are proposed per verify. Temperature 0 (the default) is
    greedy; above it, exact target sampling by accept/resample (top_p/top_k
    filter both distributions), its draws from a generator seeded by
    ``seed``."""

    def __init__(self, target_params: dict, target_cfg: llama.ModelConfig, draft_params: dict,
                 draft_cfg: llama.ModelConfig, *, k: int = 4, max_len: int = 2048,
                 kv_quantized: bool = False, temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0, device=None):
        if target_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("vocabularies must match")
        self.device = resolve_device(device)
        self.tcfg, self.dcfg, self.k, self.max_len = target_cfg, draft_cfg, k, max_len
        self.tparams = stack_layer_params(target_params)
        self.dparams = stack_layer_params(draft_params)
        with torch.inference_mode():
            self.tcache = init_kv_cache(target_cfg, 1, max_len, quantized=kv_quantized,
                                        device=self.device)
            self.dcache = init_kv_cache(draft_cfg, 1, max_len, quantized=kv_quantized,
                                        device=self.device)
        self.top_k = int(top_k)
        self._temps = torch.tensor([float(temperature)], device=self.device)
        self._top_ps = torch.tensor([float(top_p)], device=self.device)
        self._sampling = temperature > 0.0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _prefill(self, params, cfg, cache, ids: torch.Tensor, true_len: int) -> torch.Tensor:
        """The padded prompt into ``cache`` at offset 0; the token after it
        (drawn from the filtered distribution when sampling), on the device."""
        logits, _ = forward_stacked(params, cfg, ids[None, :], cache=cache, cache_offset=0,
                                    host_offsets=[0])
        last = logits[0, true_len - 1][None].float()
        tok = torch.argmax(last, dim=-1)
        if self._sampling:
            tok = categorical(torch.softmax(filter_logits(last, self._temps, self._top_ps,
                                                          self.top_k), dim=-1), self._gen)
        return tok[0]

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int) -> tuple[list, dict]:
        """Decode one prompt; returns (tokens, stats): stats holds
        ``proposed``, ``accepted``, ``acceptance`` and ``tokens``. Greedy
        output equals the target's own greedy decode."""
        prompt = np.asarray(prompt_ids, np.int64)
        n = len(prompt)
        pad = 1 << max(3, (n - 1).bit_length())  # the prefill bucket
        ids = np.zeros(pad, np.int64)
        ids[:n] = prompt
        ids_t = torch.as_tensor(ids, device=self.device)
        tok = self._prefill(self.tparams, self.tcfg, self.tcache, ids_t, n)
        self._prefill(self.dparams, self.dcfg, self.dcache, ids_t, n)  # its token is unused

        out = [int(tok)]
        offset = n  # out[-1] sits at sequence position `offset`
        proposed = accepted = 0
        k = self.k
        while len(out) < max_new_tokens and offset + k + 1 < self.max_len:
            # the token at offset-1 closes the draft cache's hole an
            # all-accepted round leaves (see draft_chunk)
            prev = out[-2] if len(out) >= 2 else int(prompt[-1])
            pl = torch.as_tensor([[prev], [out[-1]], [offset]], device=self.device)
            offs = pl[2].int()
            draft_toks, n_acc, bonus, _, _ = spec_round(
                self.tparams, self.tcfg, self.tcache, self.dparams, self.dcfg, self.dcache,
                pl[0], pl[1], offs, [offset], self._temps, self._top_ps, k=k, top_k=self.top_k,
                generator=self._gen, any_sampling=self._sampling)
            row = torch.cat([draft_toks[0], n_acc, bonus]).tolist()  # one read-back
            na = row[k]
            out.extend(row[:na] + [row[k + 1]])
            proposed += k
            accepted += na
            # the accepted prefix and the bonus advance the offset; stale rows
            # past it are masked and overwritten by the next round
            offset += na + 1
        stats = {"proposed": proposed, "accepted": accepted,
                 "acceptance": accepted / max(proposed, 1), "tokens": len(out[:max_new_tokens])}
        return out[:max_new_tokens], stats
