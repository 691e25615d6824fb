"""Fused KV write + single-token flash-decode attention over the stacked cache.

PyTorch counterpart of ``aqlm_tpu.ops.flash_decode.
flash_decode_write_attention_indexed``. On a CUDA tensor it launches kernel
K3 (``csrc/flash_decode.cu``); on a CPU tensor it runs the plain version.
Both write the new row into the cache IN PLACE and return the cache tensors
they were given, so callers read the same objects back.

Layouts: q [B, 1, Hq, D]; k/v cache [L, B, Hkv, S, D] int8 or bf16; scales
[L, B, Hkv, S, 1] f32 (int8 only); offsets [B] int32 (row b is written at
offsets[b] and attends to keys < offsets[b] + 1).
"""

from __future__ import annotations

import torch

from aqlm_tpu_torch.ops import _build

__all__ = ["flash_decode_write_attention_indexed", "NEG_INF"]

NEG_INF = -1e30


def plain(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window):
    """K3's plain version. One layer's cache [B, Hkv, S, D] (+ scales
    [B, Hkv, S, 1]); q_hm [B, Hkv, rep, D] bf16; nk/nv [B, Hkv, D]; nks/nvs
    [B, Hkv] or None."""
    b = q_hm.shape[0]
    s_len = k_c.shape[2]
    rows = torch.arange(b, device=k_c.device)
    off = offsets.long()
    k_c[rows, :, off] = nk
    v_c[rows, :, off] = nv
    if ks_c is not None:
        ks_c[rows, :, off] = nks[..., None]
        vs_c[rows, :, off] = nvs[..., None]
        k = k_c.float() * ks_c.float()
        v = v_c.float() * vs_c.float()
    else:
        k, v = k_c.float(), v_c.float()
    logits = torch.einsum("bhrd,bhsd->bhrs", q_hm.float(), k) * scale
    length = (off + 1)[:, None, None, None]
    key_pos = torch.arange(s_len, device=k_c.device)[None, None, None, :]
    valid = key_pos < length
    if window is not None:
        valid = valid & (key_pos >= length - window)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhrs,bhsd->bhrd", p, v) / torch.clamp(l, min=1e-30)
    return out.to(torch.bfloat16)


def launch(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window):
    """K3 on one layer's cache (same arguments as ``plain``). Each offset must
    lie in [0, S), as the caller (the Engine) guarantees; the kernel does not
    read offsets back to the host, so a row whose offset lies outside writes
    nothing and returns NaN instead of raising."""
    b, hkv, rep, d = q_hm.shape
    s_len = k_c.shape[2]
    dev = q_hm.device
    quant = k_c.dtype == torch.int8
    if d not in (64, 128) or rep < 1:
        raise NotImplementedError(f"flash_decode kernel takes head_dim 64/128 and at least one query "
                                  f"head per kv head, got D={d}, rep={rep}")
    if not quant and k_c.dtype != torch.bfloat16:
        raise ValueError(f"flash_decode kernel takes an int8 or bf16 cache, got {k_c.dtype}")
    if quant and (ks_c is None or vs_c is None or ks_c.dtype != torch.float32
                  or nks is None or nvs is None):
        raise ValueError("an int8 cache needs f32 scale planes and new-row scales")
    if offsets.dtype != torch.int32 or offsets.shape != (b,):
        raise ValueError("offsets must be int32 [B]")
    if k_c.shape != (b, hkv, s_len, d) or v_c.shape != k_c.shape or v_c.dtype != k_c.dtype:
        raise ValueError(f"cache {tuple(k_c.shape)} does not match q {tuple(q_hm.shape)}")
    ops = [q_hm, nk, nv, k_c, v_c, offsets] + ([nks, nvs, ks_c, vs_c] if quant else [])
    for t in ops:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("flash_decode kernel operands must be contiguous on one CUDA device")
    if rep not in (1, 2, 4, 8) and (nk.data_ptr() % 16 or nv.data_ptr() % 16):
        # the chunked instances read the new row as cache rows are read
        raise ValueError("flash_decode kernel needs 16-byte aligned new rows at this head count")
    out = torch.empty((b, hkv, rep, d), dtype=torch.bfloat16, device=dev)
    lib, _ = _build.library()
    rc = lib.flash_decode_write_launch(
        q_hm.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        nks.data_ptr() if quant else None, nvs.data_ptr() if quant else None,
        k_c.data_ptr(), v_c.data_ptr(),
        ks_c.data_ptr() if quant else None, vs_c.data_ptr() if quant else None,
        offsets.data_ptr(), out.data_ptr(),
        b, hkv, s_len, d, rep, int(quant), 0 if window is None else int(window), float(scale),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "flash_decode_write")
    _build.KERNELS["flash_decode_write"].launches += 1
    return out


def flash_decode_write_attention_indexed(
    q, k_new, v_new, k_all, v_all, ks_all, vs_all, layer_idx: int, offsets,
    *, k_scale_new=None, v_scale_new=None, scale: float | None = None,
    window: int | None = None,
):
    """Writes the new KV row (and scales) of every batch row b into layer
    ``layer_idx`` at ``offsets[b]``, in place, and returns flash attention of
    the single query token over keys < offsets + 1 (within ``window`` when
    given).

    q [B, 1, Hq, D]; k_new/v_new [B, 1, Hkv, D]; k_scale_new/v_scale_new
    [B, 1, Hkv, 1] for an int8 cache. Returns (attn [B, 1, Hq, D] bf16,
    k_all, v_all, ks_all, vs_all), the caches being the objects passed in."""
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError("flash decode is the single-token path")
    hkv = k_all.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} kv heads")
    rep = hq // hkv
    if scale is None:
        scale = d ** -0.5
    li = int(layer_idx)
    q_hm = q.reshape(b, hkv, rep, d).to(torch.bfloat16).contiguous()
    nk = k_new[:, 0].to(k_all.dtype).contiguous()
    nv = v_new[:, 0].to(v_all.dtype).contiguous()
    nks = None if k_scale_new is None else k_scale_new[:, 0, :, 0].float().contiguous()
    nvs = None if v_scale_new is None else v_scale_new[:, 0, :, 0].float().contiguous()
    k_c, v_c = k_all[li], v_all[li]
    ks_c = None if ks_all is None else ks_all[li]
    vs_c = None if vs_all is None else vs_all[li]
    if q.device.type == "cpu":
        attn = plain(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window)
    elif q.device.type == "cuda":
        attn = launch(q_hm, nk, nv, nks, nvs, k_c, v_c, ks_c, vs_c, offsets, scale, window)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return attn.reshape(b, 1, hq, d), k_all, v_all, ks_all, vs_all
