"""Continuous-batching decode engine (PyTorch counterpart of
``aqlm_tpu.serve.engine``).

- one decode step for the active slot prefix per call: the stacked model's
  layer loop over the in-place KV cache;
- per-request prefill into a free slot, padded to a bucket; prompts longer
  than the largest bucket prefill in chunks;
- requests join and leave the batch between steps, or leave it early by
  ``abort``; a prompt whose prefix already sits in another slot's cache rows
  copies them instead of recomputing (prefix cache, ``prefix_cache``);
- with ``decode_chunk > 1`` one step runs up to that many forwards, each
  token sampled on the device and fed to the next, and reads the tokens
  back once per chunk: no host sync between the chunk's first forward and
  its last;
- with ``draft_params`` a step is one batched draft-and-verify round
  (speculative decoding, ``serve.speculative``): k+1 draft forwards over
  the slot prefix and one [bucket, k+1] target forward, with one read-back
  per round; a draft that is accepted too rarely is dropped for good.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np
import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama, mixtral
from aqlm_tpu_torch.models.stacked import forward_stacked, init_kv_cache, stack_layer_params
from aqlm_tpu_torch.ops.runtime import QuantizedLinear
from aqlm_tpu_torch.serve.fuse import (
    fuse_projections,
    fuse_projections_codes,
    quantize_lm_head_int8,
)
from aqlm_tpu_torch.serve.sampler import SamplingParams, sample_tokens
from aqlm_tpu_torch.serve.speculative import spec_round

__all__ = ["ServeConfig", "Engine", "Request", "serving_params"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    max_len: int = 2048
    prefill_buckets: tuple = (64, 256, 1024)
    kv_quantized: bool = False  # int8 KV cache
    top_k: int = 0  # top-k bound for the sampler
    fuse_projections: bool = True  # QKV / gate+up fusion of int8, int4 and codes layers
    lm_head_int8: bool = False  # int8-quantize the output head
    donate_params: bool = False  # free the caller's params during load (big models)
    use_flash_decode: bool | None = None  # None = forward_stacked's rule; True/False force K3
    prefix_cache: bool = True  # reuse KV rows for shared prompt prefixes
    min_prefix: int = 16  # smallest prefix worth a copy instead of recompute
    # speculative decoding: drop the draft for good once spec_warmup
    # proposals are measured and fewer than this share were accepted
    spec_min_acceptance: float = 0.7
    spec_warmup: int = 64
    decode_chunk: int = 1  # >1: up to this many tokens per step, one host sync per chunk


def serving_params(params: dict, cfg: llama.ModelConfig, serve: ServeConfig) -> dict:
    """The Engine's load-time transforms, in ``aqlm_tpu``'s order: int8 and
    int4 fusion, codes fusion, the int8 lm_head, a Mixtral's int8 or int4
    experts stacked into all-expert operands, then stacking the layers. With
    ``serve.donate_params`` every step frees the caller's copy as it goes,
    so a model near the card's size loads with one stacked leaf of headroom."""
    donate = serve.donate_params
    if serve.fuse_projections:
        params = fuse_projections_codes(fuse_projections(params, cfg, donate=donate), cfg,
                                        donate=donate)
    if serve.lm_head_int8:
        params = quantize_lm_head_int8(params)
    layers = params["layers"]
    if layers and "moe_gate" in layers[0]:
        # int8 and int4 experts: one all-expert launch per projection; codes
        # experts stay as the caller left them (stacked by mixtral.stack_experts:
        # all-expert launches; else per expert), reference experts per expert
        e0 = layers[0].get("experts.0.gate_proj")
        if isinstance(e0, QuantizedLinear) and e0.mode in ("int8", "int4"):
            params = {**params, "layers": [mixtral.stack_experts(l, cfg, donate=donate)
                                           for l in layers]}
    return stack_layer_params(params, donate=donate)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    sampling: SamplingParams
    generated: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    done: bool = False


class Engine:
    """Continuous-batching engine. ``params``: Llama, Mixtral or Falcon params
    (projections DenseLinear or QuantizedLinear) on ``device`` (None = the
    card); int8, int4 and codes projections sharing an input are fused
    (q/k/v, gate/up), the head quantized to int8 if asked, a Mixtral's int8
    or int4 experts stacked, and every layer stacked once at construction
    (``serving_params``).

    ``draft_params`` (a Llama-family model of ``draft_cfg``, default ``cfg``,
    with the same vocabulary) turns on speculative decoding with ``spec_k``
    proposals a round. The draft gets the projection fusion only (no int8
    head, no expert stacking), its own stacked params and its own KV cache."""

    def __init__(self, params: dict, cfg: llama.ModelConfig, serve: ServeConfig = ServeConfig(),
                 *, device=None, draft_params: dict | None = None,
                 draft_cfg: llama.ModelConfig | None = None, spec_k: int = 4):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, engine on {self.device}")
        self.cfg = cfg
        # a prefill bucket wider than the KV cache cannot be written; clamp
        if max(serve.prefill_buckets) > serve.max_len:
            serve = dataclasses.replace(
                serve,
                prefill_buckets=tuple(sorted({min(b, serve.max_len) for b in serve.prefill_buckets})),
            )
        self.serve = serve
        self.params = serving_params(params, cfg, serve)
        with torch.inference_mode():
            self.cache = init_kv_cache(cfg, serve.max_batch, serve.max_len,
                                       quantized=serve.kv_quantized, device=self.device)
        # lowest-first slot allocation keeps active slots in a prefix so the
        # decode batch bucket stays tight
        self._free_slots = list(range(serve.max_batch))
        heapq.heapify(self._free_slots)
        self._active: dict[int, Request] = {}
        self._pending: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self._next_rid = 0
        B = serve.max_batch
        self._offsets = np.zeros(B, np.int32)  # next write position per slot
        self._last_token = np.zeros(B, np.int64)
        self._temps = np.zeros(B, np.float32)
        self._top_ps = np.ones(B, np.float32)
        self._budgets = np.zeros(B, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # prefix cache: per slot, the prompt whose KV occupies rows [0:len)
        self._slot_prompts: dict[int, np.ndarray] = {}
        self.prefix_stats = {"hits": 0, "tokens_reused": 0}

        # ---- batched speculative decoding (continuous batching + draft) ----
        self._spec = draft_params is not None
        if self._spec:
            dcfg = draft_cfg or cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft vocab must match")
            if "moe_gate" in (draft_params.get("layers") or [{}])[0]:
                raise ValueError("MoE draft models are not supported")
            if draft_params["embed"].device.type != self.device.type:
                raise ValueError(f"draft params live on {draft_params['embed'].device}, "
                                 f"engine on {self.device}")
            dp = draft_params
            if serve.fuse_projections:
                donate = serve.donate_params
                dp = fuse_projections_codes(fuse_projections(dp, dcfg, donate=donate), dcfg,
                                            donate=donate)
            self._dcfg = dcfg
            self._dparams = stack_layer_params(dp, donate=serve.donate_params)
            with torch.inference_mode():
                self._dcache = init_kv_cache(dcfg, B, serve.max_len, quantized=serve.kv_quantized,
                                             device=self.device)
            self.spec_k = spec_k
            self.spec_stats = {"proposed": 0, "accepted": 0}
            self.spec_disabled = False  # adaptive: see spec_min_acceptance
        self._prev_token = np.zeros(B, np.int64)  # the token at offset-1 (speculation)

    # ---- bucketing ---------------------------------------------------------

    def _decode_bucket(self) -> int:
        """Smallest power-of-two slot prefix covering every active slot."""
        hi = max(self._active) + 1
        b = 1
        while b < hi:
            b *= 2
        return min(b, self.serve.max_batch)

    def _bucket(self, n: int) -> int:
        for b in self.serve.prefill_buckets:
            if n <= b:
                return b
        return max(self.serve.prefill_buckets)

    def _prefill_chunks(self, n: int):
        """(start, length, bucket) chunks covering an n-token prompt."""
        big = max(self.serve.prefill_buckets)
        chunks, start = [], 0
        while n - start > big:
            chunks.append((start, big, big))
            start += big
        rem = n - start
        chunks.append((start, rem, self._bucket(rem)))
        return chunks

    def _chunks_from(self, start: int, n: int):
        return [(start + s, l, b) for s, l, b in self._prefill_chunks(n - start)]

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _prefill(self, ids: np.ndarray, slot: int, start: int, true_len: int, temp: float,
                 top_p: float):
        """Prefill one chunk (batch 1, padded to its bucket) into ``slot`` at
        cache offset ``start``; returns (token, logprob) of its last real
        position."""
        logits, _ = forward_stacked(
            self.params, self.cfg, self._tensor(ids, torch.long)[None, :],
            cache=self.cache.rows(slot, slot + 1), cache_offset=start,
        )
        last = logits[0, true_len - 1][None].float()
        tok = sample_tokens(last, self._gen, self._tensor([temp], torch.float32),
                            self._tensor([top_p], torch.float32), top_k=self.serve.top_k,
                            any_sampling=temp > 0)[0]
        logp = torch.log_softmax(last[0], dim=-1)
        return int(tok), float(logp[tok])

    def _prefill_draft(self, ids: np.ndarray, slot: int, start: int) -> None:
        """The draft's prefill of one chunk into ``slot`` at ``start`` (its
        logits unused: the target's prefill picks the token)."""
        forward_stacked(self._dparams, self._dcfg, self._tensor(ids, torch.long)[None, :],
                        cache=self._dcache.rows(slot, slot + 1), cache_offset=start)

    def _copy_prefix(self, src: int, dst: int, rows: int) -> None:
        caches = (self.cache, self._dcache) if self._spec else (self.cache,)
        for cache in caches:
            for a in cache.tensors():
                a[:, dst, :, :rows] = a[:, src, :, :rows]

    # ---- public API --------------------------------------------------------

    def submit(self, prompt_ids, sampling: SamplingParams = SamplingParams()) -> int:
        prompt = np.asarray(prompt_ids, np.int64)
        room = self.serve.max_len - (self.spec_k + 2 if self._spec else 2)
        if len(prompt) > room:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no decode room at "
                f"max_len={self.serve.max_len} (limit {room})"
            )
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, sampling=sampling)
        self._pending.append(req)
        self.requests[rid] = req
        return rid

    def get_request(self, rid: int) -> Request:
        return self.requests[rid]

    def abort(self, rid: int) -> bool:
        """Cancel a request: a pending one leaves the queue, an active one
        frees its slot for the next step. False if it is unknown or done."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return False
        req.done = True
        if req.slot is not None and req.slot in self._active:
            del self._active[req.slot]
            heapq.heappush(self._free_slots, req.slot)
        elif req in self._pending:
            self._pending.remove(req)
        return True

    def _find_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Longest reusable prompt prefix held in some slot's cache rows
        (0 below min_prefix); capped at len(prompt) - 1 so the last prompt
        token always prefills."""
        best_slot, best_len = None, 0
        for s, toks in self._slot_prompts.items():
            m = min(len(toks), len(prompt))
            eq = toks[:m] == prompt[:m]
            l = int(eq.argmin()) if not eq.all() else m
            if l > best_len or (l == best_len and s == slot):
                best_slot, best_len = s, l
        best_len = min(best_len, len(prompt) - 1)
        if best_slot is None or best_len < self.serve.min_prefix:
            return 0
        if best_slot != slot:
            rows = min(1 << (best_len - 1).bit_length(), self.serve.max_len)
            self._copy_prefix(best_slot, slot, rows)
        self.prefix_stats["hits"] += 1
        self.prefix_stats["tokens_reused"] += best_len
        return best_len

    def _admit(self):
        while self._pending and self._free_slots:
            req = self._pending.popleft()
            slot = heapq.heappop(self._free_slots)
            req.slot = slot
            reused = self._find_prefix(slot, req.prompt) if self.serve.prefix_cache else 0
            self._slot_prompts[slot] = req.prompt.copy()
            for start, length, bucket in self._chunks_from(reused, len(req.prompt)):
                ids = np.zeros(bucket, np.int64)
                ids[:length] = req.prompt[start:start + length]
                tok, lp = self._prefill(ids, slot, start, length, req.sampling.temperature,
                                        req.sampling.top_p)
            if self._spec and not self.spec_disabled:
                for start, length, bucket in self._chunks_from(reused, len(req.prompt)):
                    ids = np.zeros(bucket, np.int64)
                    ids[:length] = req.prompt[start:start + length]
                    self._prefill_draft(ids, slot, start)
                self._prev_token[slot] = req.prompt[-1]
            req.generated.append(tok)  # sampled from the final chunk's last position
            req.logprobs.append(lp)
            self._active[slot] = req
            self._offsets[slot] = len(req.prompt)
            self._last_token[slot] = tok
            self._temps[slot] = req.sampling.temperature
            self._top_ps[slot] = req.sampling.top_p
            self._budgets[slot] = req.sampling.max_new_tokens - 1
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int):
        req = self._active.get(slot)
        if req is None:
            return
        eos = req.sampling.eos_token_id
        if self._budgets[slot] <= 0 or (eos is not None and req.generated and req.generated[-1] == eos):
            req.done = True
            del self._active[slot]
            heapq.heappush(self._free_slots, slot)

    def _forward_sample(self, tokens, offsets, temps, top_ps, bucket: int, any_sampling: bool):
        """One decode forward over slots [0, bucket) and its sampling, all on
        the device: (tokens [bucket], their logprobs [bucket])."""
        logits, _ = forward_stacked(
            self.params, self.cfg, tokens, cache=self.cache.rows(0, bucket),
            cache_offset=offsets, use_flash_decode=self.serve.use_flash_decode,
        )
        last = logits[:, -1, :].float()
        toks = sample_tokens(last, self._gen, temps, top_ps, top_k=self.serve.top_k,
                             any_sampling=any_sampling)
        lps = torch.log_softmax(last, dim=-1).gather(-1, toks[:, None])[:, 0]
        return toks, lps

    def _decode_chunk(self, tokens, offsets, temps, top_ps, bucket: int, n: int,
                      any_sampling: bool):
        """n decode forwards, each fed the tokens the one before sampled, with
        no host sync: (tokens [n, bucket], logprobs [n, bucket]) on the device."""
        toks = torch.empty((n, bucket), dtype=torch.long, device=self.device)
        lps = torch.empty((n, bucket), dtype=torch.float32, device=self.device)
        for i in range(n):
            nxt, lp = self._forward_sample(tokens, offsets, temps, top_ps, bucket, any_sampling)
            toks[i], lps[i] = nxt, lp
            tokens, offsets = nxt[:, None], offsets + 1
        return toks, lps

    def _decode_steps(self, bucket: int, n: int) -> dict:
        """n decode steps over slots [0, bucket) with one read-back: a single
        step at n = 1 ({rid: token}), a chunk above ({rid: [tokens]}, as
        ``aqlm_tpu``'s ``_chunk_step``). Slots that reach EOS or their budget
        inside a chunk decode on; their tail tokens are dropped here, and the
        rows they wrote lie past the finished request, overwritten when the
        slot is reused."""
        toks, lps = self._decode_chunk(
            self._tensor(self._last_token[:bucket, None], torch.long),
            self._tensor(self._offsets[:bucket], torch.int32),
            self._tensor(self._temps[:bucket], torch.float32),
            self._tensor(self._top_ps[:bucket], torch.float32),
            bucket, n, bool((self._temps[:bucket] > 0).any()),
        )
        toks, lps = toks.cpu().numpy(), lps.cpu().numpy()
        emitted = {}
        for slot, req in list(self._active.items()):
            take = min(n, int(self._budgets[slot]))
            sub = [int(t) for t in toks[:take, slot]]
            eos = req.sampling.eos_token_id
            if eos is not None and eos in sub:
                sub = sub[: sub.index(eos) + 1]
                self._budgets[slot] = 0
            req.generated.extend(sub)
            req.logprobs.extend(float(l) for l in lps[: len(sub), slot])
            emitted[req.rid] = sub if n > 1 else sub[0]
            self._offsets[slot] += n  # the cache advanced n rows regardless
            self._budgets[slot] -= n
            self._last_token[slot] = toks[-1, slot]
            if self._offsets[slot] >= self.serve.max_len - 1:
                self._budgets[slot] = 0
            self._maybe_finish(slot)
        return emitted

    def _spec_round(self, prev, last, offsets, host_offsets: list, temps, top_ps, bucket: int,
                    any_sampling: bool) -> torch.Tensor:
        """One draft-and-verify round over slots [0, bucket) on the device,
        with no host sync: [bucket, 2k+3] f64, each row its k proposals,
        n_acc and the bonus token, then the proposals' and the bonus's
        logprobs (one tensor, so the round reads back once)."""
        outs = spec_round(self.params, self.cfg, self.cache.rows(0, bucket), self._dparams,
                          self._dcfg, self._dcache.rows(0, bucket), prev, last, offsets,
                          host_offsets, temps, top_ps, k=self.spec_k, top_k=self.serve.top_k,
                          generator=self._gen, any_sampling=any_sampling,
                          use_flash_decode=self.serve.use_flash_decode)
        draft_toks, n_acc, bonus, lp_d, lp_bonus = outs
        return torch.cat([draft_toks.double(), n_acc[:, None].double(), bonus[:, None].double(),
                          lp_d.double(), lp_bonus[:, None].double()], dim=1)

    def _spec_step(self) -> dict:
        """One batched draft-and-verify round; emits up to spec_k+1 tokens
        per active slot ({rid: [tokens]})."""
        bucket = self._decode_bucket()
        k = self.spec_k
        offsets = self._offsets[:bucket].copy()
        # an idle slot inside the bucket runs the round too; its stale offset
        # (0, or near the cache's end) is moved so that its k+2 rows of writes
        # stay inside the cache and past any prompt the slot still holds
        idle = [s for s in range(bucket) if s not in self._active]
        offsets[idle] = np.clip(offsets[idle], 1, self.serve.max_len - 1 - k)
        ints = self._tensor(np.stack([self._prev_token[:bucket], self._last_token[:bucket],
                                      offsets]), torch.long)
        floats = self._tensor(np.stack([self._temps[:bucket], self._top_ps[:bucket]]),
                              torch.float32)
        out = self._spec_round(ints[0], ints[1], ints[2].int(), offsets.tolist(), floats[0],
                               floats[1], bucket, bool((self._temps[:bucket] > 0).any()))
        out = out.cpu().numpy()  # the round's one read-back
        draft_toks, n_acc, bonus = out[:, :k], out[:, k], out[:, k + 1]
        lp_d, lp_bonus = out[:, k + 2:2 * k + 2], out[:, 2 * k + 2]
        emitted = {}
        for slot, req in list(self._active.items()):
            na = int(n_acc[slot])
            chunk = [int(t) for t in draft_toks[slot, :na]] + [int(bonus[slot])]
            chunk_lps = [float(l) for l in lp_d[slot, :na]] + [float(lp_bonus[slot])]
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += na
            # the cache rows advanced by the whole accepted chunk and its bonus
            before_last = [int(self._last_token[slot])] + chunk
            self._offsets[slot] += na + 1
            self._budgets[slot] -= na + 1
            eos = req.sampling.eos_token_id
            if eos is not None and eos in chunk:
                chunk = chunk[: chunk.index(eos) + 1]
                self._budgets[slot] = 0
            if self._budgets[slot] < 0:  # the budget's truncation ends the request
                chunk = chunk[: self._budgets[slot]]
                self._budgets[slot] = 0
            req.generated.extend(chunk)
            req.logprobs.extend(chunk_lps[: len(chunk)])
            emitted[req.rid] = chunk
            self._last_token[slot] = before_last[len(chunk)]
            self._prev_token[slot] = before_last[len(chunk) - 1]
            if self._offsets[slot] >= self.serve.max_len - (k + 2):
                self._budgets[slot] = 0
            self._maybe_finish(slot)
        return emitted

    @torch.inference_mode()
    def step(self) -> dict:
        """Admit pending requests, run one batched decode step.
        Returns {rid: new_token} for the tokens produced this step
        ({rid: [tokens]} for a chunk when decode_chunk > 1, and for a
        speculative round)."""
        self._admit()
        if not self._active:
            return {}
        if self._spec and not self.spec_disabled:
            emitted = self._spec_step()
            # adaptive speculation: a draft that rarely agrees costs k extra
            # forwards a round for nothing; it is dropped for good (its cache
            # goes stale once it stops being kept)
            st = self.spec_stats
            if (self.serve.spec_min_acceptance > 0.0 and st["proposed"] >= self.serve.spec_warmup
                    and st["accepted"] < self.serve.spec_min_acceptance * st["proposed"]):
                self.spec_disabled = True
            return emitted
        n = 1
        if self.serve.decode_chunk > 1 and not self._pending:
            # chunked decode: n steps per host sync, no more than the longest
            # remaining budget or anyone's cache room
            room = min(self.serve.max_len - 1 - int(self._offsets[s]) for s in self._active)
            n = max(1, min(self.serve.decode_chunk, room,
                           max(int(self._budgets[s]) for s in self._active)))
        return self._decode_steps(self._decode_bucket(), n)

    def generate(self, prompts, sampling: SamplingParams = SamplingParams()) -> list:
        """Blocking batch generate: returns a list of generated-token lists."""
        rids = [self.submit(p, sampling) for p in prompts]
        while self._pending or self._active:
            self.step()
        return [self.requests[rid].generated for rid in rids]
