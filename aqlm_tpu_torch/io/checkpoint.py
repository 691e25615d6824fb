"""Load side of the canonical checkpoint format (PyTorch counterpart of
``aqlm_tpu.io.checkpoint``).

A model directory holds ``config.json``, ``shared.npz`` (embeddings, final
norm, lm_head) and one ``layer_{i}.npz`` per block with flat
``name.field -> array`` entries. bf16 arrays are stored as a uint16 view
under a ``::bf16``-suffixed key. Layers are canonical AQLM weights
(reference mode) or materialized runtime layouts; of the latter the port
reads the codes-mode (tiled and untiled), the int8 and the int4 layouts.
``model_family`` in ``config.json`` picks the config class (Llama, Mixtral
or Falcon; a Mixtral's experts are flat ``experts.{e}.*`` layer entries like
any projection; a Falcon's biased final LayerNorm adds ``final_norm_bias`` to
``shared.npz``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.family import config_class
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.ops.dequant import AqlmWeight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported

__all__ = ["load_layer_checkpoint", "load_quantized_model"]

_BF16_SUFFIX = "::bf16"


def _loadz(path: str) -> dict:
    """npz -> {key: tensor on the CPU} (``::bf16`` keys decoded to bf16);
    string entries stay numpy."""
    out = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            a = data[k]
            if k.endswith(_BF16_SUFFIX):
                out[k[: -len(_BF16_SUFFIX)]] = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
            elif a.dtype.kind in "US":
                out[k] = a
            else:
                out[k] = torch.from_numpy(a.copy())
    return out


def _layer_from_flat(arrays: dict, meta: dict, device) -> dict:
    get = lambda key: arrays[key].to(device) if key in arrays else None
    layer = {}
    for name, m in meta.items():
        if m["kind"] == "runtime" and m["mode"] == "int8":
            layer[name] = QuantizedLinear(
                codes=None, codebooks=None, scales=get(f"{name}.scales"), bias=get(f"{name}.bias"),
                scheme=AqlmScheme.parse(m["scheme"]), mode="int8", w8=get(f"{name}.w8"),
                w8_scale=get(f"{name}.w8_scale"),
            )
        elif m["kind"] == "runtime" and m["mode"] == "int4":
            layer[name] = QuantizedLinear(
                codes=None, codebooks=None, scales=get(f"{name}.scales"), bias=get(f"{name}.bias"),
                scheme=AqlmScheme.parse(m["scheme"]), mode="int4", w4=get(f"{name}.w4"),
                w4_gscale=get(f"{name}.w4_gscale"),
            )
        elif m["kind"] == "runtime":
            if m["mode"] != "codes":
                raise ValueError(f"unknown runtime mode {m['mode']!r} in the checkpoint")
            if f"{name}.codes_tl" not in arrays and f"{name}.codes_t" not in arrays:
                raise not_ported("codes checkpoints for 16-bit codebooks (1x16 gather)", "B1")
            scheme = AqlmScheme.parse(m["scheme"])
            layer[name] = QuantizedLinear(
                codes=None, codebooks=get(f"{name}.codebooks"), scales=get(f"{name}.scales"),
                bias=get(f"{name}.bias"), scheme=scheme, mode="codes",
                codes_tl=get(f"{name}.codes_tl"), codes_t=get(f"{name}.codes_t"),
            )
        elif m["kind"] == "quantized":
            w = AqlmWeight(codes=get(f"{name}.codes"), codebooks=get(f"{name}.codebooks"),
                           scales=get(f"{name}.scales"), bias=get(f"{name}.bias"),
                           scheme=AqlmScheme.parse(m["scheme"]))
            layer[name] = QuantizedLinear.from_aqlm(w, mode="reference")
        elif m["kind"] == "dense":
            layer[name] = DenseLinear(weight=get(f"{name}.weight"), bias=get(f"{name}.bias"))
        else:
            layer[name] = get(name)
    return layer


def load_layer_checkpoint(save_dir: str, layer_index: int, device=None):
    """The block's params dict on ``device`` (None = the card), or None if
    no checkpoint exists."""
    dev = resolve_device(device)
    path = os.path.join(save_dir, f"layer_{layer_index}.npz")
    if not os.path.exists(path):
        return None
    arrays = _loadz(path)
    meta = json.loads(str(arrays.pop("__meta__")))
    return _layer_from_flat(arrays, meta, dev)


def load_quantized_model(save_dir: str, device=None) -> tuple[dict, ModelConfig]:
    """(params, cfg) of a Llama, Mixtral or Falcon checkpoint, on ``device``
    (None = the card)."""
    dev = resolve_device(device)
    with open(os.path.join(save_dir, "config.json")) as f:
        config = json.load(f)
    mc = dict(config["model_config"])
    if mc.get("rope_scaling") is not None:
        mc["rope_scaling"] = tuple(mc["rope_scaling"])
    cfg = config_class(config.get("model_family", "llama"))(**mc)
    data = _loadz(os.path.join(save_dir, "shared.npz"))
    lm_head = None
    if "lm_head.weight" in data:
        lm_head = DenseLinear(
            weight=data["lm_head.weight"].to(dev),
            bias=data["lm_head.bias"].to(dev) if "lm_head.bias" in data else None,
        )
    layers = []
    for li in range(cfg.num_layers):
        layer = load_layer_checkpoint(save_dir, li, device=dev)
        if layer is None:
            raise FileNotFoundError(f"missing layer_{li}.npz in {save_dir}")
        layers.append(layer)
    params = {"embed": data["embed"].to(dev), "layers": layers,
              "final_norm": data["final_norm"].to(dev), "lm_head": lm_head}
    if "final_norm_bias" in data:
        params["final_norm_bias"] = data["final_norm_bias"].to(dev)
    return params, cfg
