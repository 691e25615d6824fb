"""Continuous-batching decode engine (PyTorch counterpart of
``aqlm_tpu.serve.engine``).

- one decode step for the active slot prefix per call: the stacked model's
  layer loop over the in-place KV cache;
- per-request prefill into a free slot, padded to a bucket; prompts longer
  than the largest bucket prefill in chunks;
- requests join and leave the batch between steps; a prompt whose prefix
  already sits in another slot's cache rows copies them instead of
  recomputing (prefix cache).

Speculative decoding and ``decode_chunk > 1`` are not ported yet and raise
``NotImplementedError``.
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
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported
from aqlm_tpu_torch.serve.fuse import (
    fuse_projections,
    fuse_projections_codes,
    quantize_lm_head_int8,
)
from aqlm_tpu_torch.serve.sampler import SamplingParams, sample_tokens

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
    min_prefix: int = 16  # smallest prefix worth a copy instead of recompute
    decode_chunk: int = 1  # >1 not ported


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
        # int8 and int4 experts: one all-expert launch per projection;
        # codes and reference experts run per expert
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
    (``serving_params``)."""

    def __init__(self, params: dict, cfg: llama.ModelConfig, serve: ServeConfig = ServeConfig(),
                 *, device=None, draft_params: dict | None = None):
        if draft_params is not None:
            raise not_ported("speculative decoding", "A8")
        if serve.decode_chunk > 1:
            raise not_ported("decode_chunk > 1", "A6")
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
                            self._tensor([top_p], torch.float32), top_k=self.serve.top_k)[0]
        logp = torch.log_softmax(last[0], dim=-1)
        return int(tok), float(logp[tok])

    def _copy_prefix(self, src: int, dst: int, rows: int) -> None:
        for a in self.cache.tensors():
            a[:, dst, :, :rows] = a[:, src, :, :rows]

    # ---- public API --------------------------------------------------------

    def submit(self, prompt_ids, sampling: SamplingParams = SamplingParams()) -> int:
        prompt = np.asarray(prompt_ids, np.int64)
        room = self.serve.max_len - 2
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
            reused = self._find_prefix(slot, req.prompt)
            self._slot_prompts[slot] = req.prompt.copy()
            for start, length, bucket in self._chunks_from(reused, len(req.prompt)):
                ids = np.zeros(bucket, np.int64)
                ids[:length] = req.prompt[start:start + length]
                tok, lp = self._prefill(ids, slot, start, length, req.sampling.temperature,
                                        req.sampling.top_p)
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

    @torch.inference_mode()
    def step(self) -> dict:
        """Admit pending requests, run one batched decode step.
        Returns {rid: new_token} for the tokens produced this step."""
        self._admit()
        if not self._active:
            return {}
        bucket = self._decode_bucket()
        logits, _ = forward_stacked(
            self.params, self.cfg, self._tensor(self._last_token[:bucket, None], torch.long),
            cache=self.cache.rows(0, bucket),
            cache_offset=self._tensor(self._offsets[:bucket], torch.int32),
        )
        last = logits[:, -1, :].float()
        toks = sample_tokens(last, self._gen, self._tensor(self._temps[:bucket], torch.float32),
                             self._tensor(self._top_ps[:bucket], torch.float32),
                             top_k=self.serve.top_k)
        lps = torch.log_softmax(last, dim=-1).gather(-1, toks[:, None])[:, 0]
        toks, lps = toks.cpu().numpy(), lps.cpu().numpy()
        emitted = {}
        for slot, req in list(self._active.items()):
            tok = int(toks[slot])
            req.generated.append(tok)
            req.logprobs.append(float(lps[slot]))
            emitted[req.rid] = tok
            self._offsets[slot] += 1
            self._last_token[slot] = tok
            self._budgets[slot] -= 1
            if self._offsets[slot] >= self.serve.max_len - 1:
                self._budgets[slot] = 0
            self._maybe_finish(slot)
        return emitted

    def generate(self, prompts, sampling: SamplingParams = SamplingParams()) -> list:
        """Blocking batch generate: returns a list of generated-token lists."""
        rids = [self.submit(p, sampling) for p in prompts]
        while self._pending or self._active:
            self.step()
        return [self.requests[rid].generated for rid in rids]
