"""Host-resident teacher for PV distillation (PyTorch counterpart of
``aqlm_tpu.pv.teacher``).

The dense teacher's weights stay in host memory (pinned when the forward runs
on the card) and its forward streams one layer at a time to the device, so
the teacher never holds device memory beyond one block's weights. The output
is the post-final-norm hidden state [B, T, H] with the head weights: the
``teacher_kind="hidden"`` input of ``pv.straight_through.make_pv_step``,
whose chunked loss applies the head. No gradients.

``TeacherPrefetcher`` computes the hidden states of the next group of
batches in a background thread (on a CUDA stream of its own on the card),
``group_size`` batches sharing one weight-streaming pass.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading

import torch

from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import rms_norm
from aqlm_tpu_torch.pv.trainer import tree_map

__all__ = ["HostTeacher", "TeacherPrefetcher"]


def _to_host(tree, dtype, pin: bool):
    """The tree on the host, float leaves in ``dtype``; aliased leaves stay aliased."""
    memo = {}

    def conv(t):
        if t is None:
            return None
        if id(t) not in memo:
            out = t.detach().cpu()
            if out.is_floating_point():
                out = out.to(dtype)
            memo[id(t)] = out.pin_memory() if pin else out
        return memo[id(t)]

    return tree_map(conv, tree)


class HostTeacher:
    """Dense teacher params in host memory; hidden states computed on
    ``device`` (None = the card) with one block's weights there at a time.
    ``dtype``: the weights' (and so the activations') dtype, bf16 as in JAX."""

    def __init__(self, params: dict, cfg, dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.host_params = _to_host(params, dtype, pin=self.device.type == "cuda")

    def _to_dev(self, tree):
        return tree_map(lambda t: None if t is None else t.to(self.device), tree)

    def head(self) -> dict:
        """The {head, embed} entries of the teacher_kind="hidden" contract."""
        hp = self.host_params
        if hp.get("lm_head") is not None:
            return {"head": hp["lm_head"].weight.to(self.device), "embed": None}
        return {"head": None, "embed": hp["embed"].to(self.device)}

    def _embed(self, input_ids):
        ids = torch.as_tensor(input_ids).long().cpu()
        x = self.host_params["embed"][ids].to(self.device)
        if self.cfg.gemma_norm:
            x = x * torch.tensor(self.cfg.hidden_size ** 0.5, dtype=x.dtype)
        positions = torch.arange(ids.shape[1], device=self.device)[None, :].expand(ids.shape)
        return x, positions

    def _final(self, xs):
        fn = self.host_params["final_norm"].to(self.device)
        return [rms_norm(x, fn, self.cfg.rms_eps, plus_one=self.cfg.gemma_norm) for x in xs]

    @torch.no_grad()
    def hidden(self, input_ids) -> torch.Tensor:
        """Post-final-norm hidden states [B, T, H] of one batch."""
        return self.hidden_many([input_ids])[0]

    @torch.no_grad()
    def hidden_many(self, input_ids_list) -> list[torch.Tensor]:
        """Hidden states of many batches in one weight-streaming pass: each
        layer's weights go to the device once and are applied to every
        batch before the next layer's are fetched."""
        xs, poss = zip(*(self._embed(ids) for ids in input_ids_list))
        xs = list(xs)
        for layer in self.host_params["layers"]:
            lw = self._to_dev(layer)
            xs = [llama._block(x, lw, self.cfg, p) for x, p in zip(xs, poss)]
            del lw
        return self._final(xs)

    def batch(self, input_ids) -> dict:
        """The teacher input of make_pv_step(teacher_kind="hidden") for one batch."""
        return {"hidden": self.hidden(input_ids), **self.head()}


class TeacherPrefetcher:
    """Background-thread teacher pipeline: the hidden states of the next
    group of batches are computed while the main thread trains on the
    current ones. Iterating yields (input_ids, teacher_dict) pairs, in the
    order of ``batch_iter``; an error in the worker is raised on the
    consumer's side. ``close`` stops the worker."""

    def __init__(self, teacher: HostTeacher, batch_iter, *, group_size: int = 4, depth: int = 2):
        self._teacher = teacher
        self._iter = iter(batch_iter)
        self._group = max(1, group_size)
        self._q = queue.Queue(maxsize=max(1, depth) * self._group)
        self._head = teacher.head()
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close`` was called first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        dev = self._teacher.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        try:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                while not self._stop.is_set():
                    group = list(itertools.islice(self._iter, self._group))
                    if not group:
                        break
                    hs = self._teacher.hidden_many(group)
                    if stream is not None:
                        stream.synchronize()  # the consumer reads them on its own stream
                    if not all(self._put(item) for item in zip(group, hs)):
                        break
        except Exception as e:  # raised on the consumer's side
            self._err = e
        finally:
            self._put(None)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker and wait for it (it frees its batches and the
        teacher's references)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the teacher prefetch thread did not stop")

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        ids, h = item
        if h.is_cuda:  # freed only after the consumer's stream is done with it
            h.record_stream(torch.cuda.current_stream(h.device))
        return ids, {"hidden": h, **self._head}
