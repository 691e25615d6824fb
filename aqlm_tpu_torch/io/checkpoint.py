"""The canonical checkpoint format (PyTorch counterpart of
``aqlm_tpu.io.checkpoint``): both sides.

A model directory holds ``config.json``, ``shared.npz`` (embeddings, final
norm, lm_head) and one ``layer_{i}.npz`` per block with flat
``name.field -> array`` entries. bf16 arrays are stored as a uint16 view
under a ``::bf16``-suffixed key. Layers are canonical AQLM weights
(reference mode) or materialized runtime layouts; of the latter the port
reads the codes-mode (Kx8 tiled and untiled, and 1x16: codes and the packed
codebook), the int8 and the int4 layouts.
``model_family`` in ``config.json`` picks the config class (Llama, Mixtral
or Falcon; a Mixtral's experts are flat ``experts.{e}.*`` layer entries like
any projection; a Falcon's biased final LayerNorm adds ``final_norm_bias`` to
``shared.npz``).

The save side writes what ``aqlm_tpu.io.checkpoint.load_quantized_model``
reads: the same keys, dtypes and meta, and the same ``config.json`` (the
per-layer files double as the calibration's resume unit).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.device import resolve_device
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.family import config_class, family_name
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.ops.dequant import AqlmWeight
from aqlm_tpu_torch.ops.gather16 import codes16
from aqlm_tpu_torch.ops.runtime import QuantizedLinear

__all__ = ["save_layer_checkpoint", "load_layer_checkpoint", "save_quantized_model",
           "load_quantized_model"]

_BF16_SUFFIX = "::bf16"


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 as its uint16 view (keyed ``::bf16``
    by ``_savez``), 16-bit codes as uint16."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.uint16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _savez(path: str, arrays: dict) -> None:
    enc = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                k = k + _BF16_SUFFIX
            v = _np(v)
        enc[k] = v
    np.savez(path, **enc)


def _loadz(path: str) -> dict:
    """npz -> {key: tensor on the CPU} (``::bf16`` keys decoded to bf16);
    string entries stay numpy. Each array read from the archive is a fresh,
    writable buffer, so the tensors share it rather than copy it."""
    out = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            a = data[k]
            if k.endswith(_BF16_SUFFIX):
                out[k[: -len(_BF16_SUFFIX)]] = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
            elif a.dtype.kind in "US":
                out[k] = a
            else:
                out[k] = torch.from_numpy(a)
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
            scheme = AqlmScheme.parse(m["scheme"])
            if f"{name}.packed_cb" in arrays:  # 1x16: 16-bit codes and the packed codebook
                layer[name] = QuantizedLinear(
                    codes=codes16(get(f"{name}.codes")), codebooks=None,
                    scales=get(f"{name}.scales"), bias=get(f"{name}.bias"), scheme=scheme,
                    mode="codes", packed_cb=get(f"{name}.packed_cb"),
                )
                continue
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


_RUNTIME_FIELDS = ("codes", "codes_t", "codebooks", "packed_cb", "w8", "w8_scale", "scales",
                   "bias", "codes_tl", "w4", "w4_gscale")


def _layer_to_flat(layer: dict) -> tuple[dict, dict]:
    """(arrays, meta) of one block, as ``aqlm_tpu.io.checkpoint._layer_to_flat``."""
    arrays, meta = {}, {}
    for name, value in layer.items():
        if isinstance(value, QuantizedLinear) and value.mode != "reference":
            for field in _RUNTIME_FIELDS:
                v = getattr(value, field)
                if v is not None:
                    if field == "codes" and value.packed_cb is not None:
                        v = v.view(torch.uint16)  # 1x16: the int16 bits stored unsigned, as JAX stores them
                    arrays[f"{name}.{field}"] = v
            meta[name] = {"kind": "runtime", "mode": value.mode, "scheme": value.scheme.name}
        elif isinstance(value, QuantizedLinear):
            arrays[f"{name}.codes"] = value.codes
            arrays[f"{name}.codebooks"] = value.codebooks
            arrays[f"{name}.scales"] = value.scales
            if value.bias is not None:
                arrays[f"{name}.bias"] = value.bias
            meta[name] = {"kind": "quantized", "scheme": value.scheme.name}
        elif isinstance(value, DenseLinear):
            arrays[f"{name}.weight"] = value.weight
            if value.bias is not None:
                arrays[f"{name}.bias"] = value.bias
            meta[name] = {"kind": "dense"}
        else:  # a bare tensor (norm weights)
            arrays[name] = value
            meta[name] = {"kind": "array"}
    return arrays, meta


def save_layer_checkpoint(save_dir: str, layer_index: int, layer: dict) -> str:
    os.makedirs(save_dir, exist_ok=True)
    arrays, meta = _layer_to_flat(layer)
    path = os.path.join(save_dir, f"layer_{layer_index}.npz")
    _savez(path, {"__meta__": np.asarray(json.dumps(meta)), **arrays})
    return path


def save_quantized_model(save_dir: str, params: dict, cfg: ModelConfig,
                         extra_config: dict | None = None) -> str:
    """Full-model save: config.json + shared.npz + per-layer npz files."""
    os.makedirs(save_dir, exist_ok=True)
    scheme = next((v.scheme for layer in params["layers"] for v in layer.values()
                   if isinstance(v, QuantizedLinear)), None)
    config = {
        "model_family": family_name(cfg),
        "model_config": dataclasses.asdict(cfg),
        "quantization_config": None if scheme is None else {
            "quant_method": "aqlm",
            "nbits_per_codebook": scheme.nbits_per_codebook,
            "num_codebooks": scheme.num_codebooks,
            "out_group_size": scheme.out_group_size,
            "in_group_size": scheme.in_group_size,
            "linear_weights_not_to_quantize": ["model.embed_tokens.weight", "lm_head.weight"],
        },
    }
    modes = {v.mode for layer in params["layers"] for v in layer.values()
             if isinstance(v, QuantizedLinear)}
    if modes and modes != {"reference"}:
        if len(modes) != 1:
            raise ValueError(f"mixed runtime modes in one checkpoint: {modes}")
        config["runtime_mode"] = next(iter(modes))
    if extra_config:
        config.update(extra_config)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    shared = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for extra in ("final_norm_bias", "pos_embed"):
        if params.get(extra) is not None:
            shared[extra] = params[extra]
    if params.get("lm_head") is not None:
        shared["lm_head.weight"] = params["lm_head"].weight
        if params["lm_head"].bias is not None:
            shared["lm_head.bias"] = params["lm_head"].bias
    _savez(os.path.join(save_dir, "shared.npz"), shared)
    for li, layer in enumerate(params["layers"]):
        save_layer_checkpoint(save_dir, li, layer)
    return save_dir


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
