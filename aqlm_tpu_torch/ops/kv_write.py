"""In-place KV-cache row write (B8).

PyTorch counterpart of ``aqlm_tpu.ops.flash_decode.kv_write_inplace`` and
``kv_write4_inplace``. On a CUDA tensor each launches kernel B8
(``csrc/kv_write.cu``), one launch for all the arrays it is given; on a CPU
tensor it runs the plain version, indexed assignment. Both write in place
and return the tensors they were given.

Layouts (JAX's): cache [L, B, H, S, D] of any dtype, scale planes
[L, B, H, S, 1] f32; new rows head-major [B, H, 1, D], new scales
[B, H, 1, 1]; offsets [B] int32. Row b of every head lands at sequence
position offsets[b] of layer ``layer_idx``; a row whose offset lies outside
[0, S) writes nothing.
"""

from __future__ import annotations

import ctypes

import torch

from aqlm_tpu_torch.ops import _build

__all__ = ["kv_write_inplace", "kv_write4_inplace"]


def plain(caches, news, offsets) -> None:
    """B8's plain version on one layer: caches[i] [B, H, S, row] <- news[i]
    [B, H, row] at row offsets[b], skipping offsets outside [0, S). A row out
    of range writes back what its clamped position holds, so the version
    reads nothing back to the host."""
    s_len = caches[0].shape[2]
    off = offsets.long()
    keep = ((off >= 0) & (off < s_len))[:, None, None]
    off = off.clamp(0, s_len - 1)
    rows = torch.arange(off.shape[0], device=off.device)
    for cache, new in zip(caches, news):
        cache[rows, :, off] = torch.where(keep, new.to(cache.dtype), cache[rows, :, off])


def launch(caches, news, offsets) -> None:
    """B8 on one layer's planes (same arguments as ``plain``): one launch."""
    b, h, s_len = caches[0].shape[:3]
    dev = caches[0].device
    if len(caches) > 4:
        raise ValueError("kv_write kernel takes at most four planes")
    if offsets.dtype != torch.int32 or offsets.shape != (b,) or offsets.device != dev:
        raise ValueError("offsets must be int32 [B] on the cache's device")
    row_bytes = []
    for cache, new in zip(caches, news):
        if cache.shape[:3] != (b, h, s_len) or new.shape != (b, h, cache.shape[3]):
            raise ValueError(f"new rows {tuple(new.shape)} do not match cache {tuple(cache.shape)}")
        if new.dtype != cache.dtype or new.device != dev or cache.device != dev:
            raise ValueError("new rows must share the cache's dtype and device")
        if not (cache.is_contiguous() and new.is_contiguous()):
            raise ValueError("kv_write kernel operands must be contiguous")
        rb = cache.shape[3] * cache.element_size()
        if rb % 16 == 0 and (cache.data_ptr() % 16 or new.data_ptr() % 16):
            raise ValueError("kv_write kernel needs 16-byte aligned planes for 16-byte rows")
        if rb % 4 == 0 and (cache.data_ptr() % 4 or new.data_ptr() % 4):
            raise ValueError("kv_write kernel needs 4-byte aligned planes for 4-byte rows")
        row_bytes.append(rb)
    n = len(caches)
    lib, _ = _build.library()
    rc = lib.kv_write_launch(
        (ctypes.c_void_p * n)(*[c.data_ptr() for c in caches]),
        (ctypes.c_void_p * n)(*[x.data_ptr() for x in news]),
        (ctypes.c_int * n)(*row_bytes), n, offsets.data_ptr(), b, h, s_len,
        _build.stream_ptr(dev),
    )
    _build.check(rc, "kv_write")
    _build.count("kv_write")


def _write(alls, news_hm, layer_idx: int, offsets) -> None:
    li = int(layer_idx)
    caches = [a[li] for a in alls]
    news = [n[:, :, 0].to(a.dtype).contiguous() for a, n in zip(alls, news_hm)]
    dev = caches[0].device
    if dev.type == "cpu":
        plain(caches, news, offsets)
    elif dev.type == "cuda":
        launch(caches, news, offsets)
    else:
        raise ValueError(f"unsupported device {dev}")


def kv_write_inplace(cache_all, new, layer_idx: int, offsets):
    """cache_all [L, B, H, S, D] <- new [B, H, 1, D] at (layer_idx, b, :,
    offsets[b]), in place; returns cache_all."""
    _write([cache_all], [new], layer_idx, offsets)
    return cache_all


def kv_write4_inplace(k_all, v_all, ks_all, vs_all, nk, nv, nks, nvs, layer_idx: int, offsets):
    """One write of k, v and their scale planes (the int8 cache): nk/nv
    [B, H, 1, D], nks/nvs [B, H, 1, 1]. Returns (k_all, v_all, ks_all,
    vs_all), the objects passed in."""
    _write([k_all, v_all, ks_all, vs_all], [nk, nv, nks, nvs], layer_idx, offsets)
    return k_all, v_all, ks_all, vs_all
