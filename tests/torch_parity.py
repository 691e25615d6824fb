"""Helpers for the parity tests between aqlm_tpu (JAX) and aqlm_tpu_torch.

Values cross between the two frameworks only as numpy arrays; bf16 crosses
as its uint16 view."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch


def np_of(a):
    """A JAX array as numpy; bf16 as {"__bf16__": uint16 view}."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return {"__bf16__": a.view(np.uint16)}
    return a


def to_numpy_tree(node):
    """JAX params (dicts, lists, weight dataclasses) -> the numpy tree that
    aqlm_tpu_torch.convert.params_from_numpy reads."""
    if node is None or isinstance(node, (str, int, float, bool)):
        return node
    if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
        return type(node)(to_numpy_tree(v) for v in node)
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        out = {"__class__": type(node).__name__}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if f.name == "scheme":
                out[f.name] = v.name
            elif f.name == "out_sizes":
                out[f.name] = tuple(int(s) for s in v)
            elif isinstance(v, (str, float)) or v is None:
                out[f.name] = v
            elif dataclasses.is_dataclass(v):  # a LoraLinear's base
                out[f.name] = to_numpy_tree(v)
            else:
                out[f.name] = np_of(v)
        return out
    return np_of(node)


def t(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor (bf16 kept bf16)."""
    if isinstance(a, jax.Array):
        a = np_of(a)
    if isinstance(a, dict):
        return torch.from_numpy(np.array(a["__bf16__"])).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def f32(x) -> np.ndarray:
    """JAX array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=2e-3):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def engine_requests():
    """Three prompts for the engine parity tests: one longer than the largest
    bucket (two prefill chunks) and one sharing a 20-token prefix with the
    first; with their new-token budgets."""
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, 256, 24)
    p1 = rng.integers(0, 256, 40)
    p2 = np.concatenate([p0[:20], rng.integers(0, 256, 10)])
    return [(p0, 8), (p1, 4), (p2, 5)]


def run_engine(engine, sampling_cls):
    """Submit ``engine_requests`` and step until done: (tokens, logprobs)."""
    rids = [engine.submit(p, sampling_cls(max_new_tokens=n)) for p, n in engine_requests()]
    while engine._pending or engine._active:
        engine.step()
    reqs = [engine.get_request(r) for r in rids]
    return [r.generated for r in reqs], [r.logprobs for r in reqs]


def pairs_by_path(jtree, tree) -> list:
    """(port tensor, JAX array) leaf pairs of a port tree and a JAX tree of
    one structure (dicts, lists, weight dataclasses), matched by path; a
    port leaf of None (a gradient autograd left out) pairs with nothing."""
    out = []

    def walk(j, t):
        if isinstance(t, dict):
            for k in t:
                walk(j[k], t[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(j, t):
                walk(a, b)
        elif isinstance(t, torch.Tensor):
            out.append((t, j))
        elif t is not None and hasattr(t, "data_fields"):
            for n in t.data_fields:
                if getattr(t, n) is not None:
                    walk(getattr(j, n), getattr(t, n))

    walk(jtree, tree)
    return out
