"""Layer-streamed model quantization (PyTorch counterpart of
``aqlm_tpu.calib.pipeline``).

Activations stream through the model block by block. Per block: capture
X^T X of every projection's input from ``block_forward_with_taps`` (and the
block's pre-quantization outputs as finetune targets), quantize each
projection with the AQ engine into a reference-mode ``QuantizedLinear``,
optionally finetune the block against its float outputs, then propagate the
activations through the quantized block and go on. ``resume`` reloads
layers already saved; ``offload_activations`` keeps the hidden states in
host memory and moves one batch at a time to the device.

Multi-device calibration (a mesh) is not ported (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from aqlm_tpu_torch.calib.blockwise import BlockFinetuneConfig, finetune_block
from aqlm_tpu_torch.calib.engine import CalibConfig, XTXAccumulator, _sync, quantize_weight
from aqlm_tpu_torch.config import AqlmScheme
from aqlm_tpu_torch.io.checkpoint import load_layer_checkpoint, save_layer_checkpoint
from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.common import DenseLinear
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.ops.dequant import AqlmWeight
from aqlm_tpu_torch.ops.runtime import QuantizedLinear, not_ported

__all__ = ["QuantizePipelineConfig", "quantize_model", "SEQUENTIAL_GROUPS"]

# the reference's true-sequential group order
SEQUENTIAL_GROUPS = (
    ("q_proj", "k_proj", "v_proj"),
    ("o_proj",),
    ("up_proj", "gate_proj"),
    ("down_proj",),
)


@dataclasses.dataclass
class QuantizePipelineConfig:
    scheme: AqlmScheme = dataclasses.field(default_factory=lambda: AqlmScheme(1, 16, 8))
    calib: CalibConfig = dataclasses.field(default_factory=CalibConfig)
    finetune: BlockFinetuneConfig | None = dataclasses.field(default_factory=BlockFinetuneConfig)
    true_sequential: bool = False
    batch_size: int = 4  # samples per activation-capture forward
    skip_names: tuple = ()  # projections to keep dense
    # per-projection scheme overrides: ((name_substring, AqlmScheme), ...), first match wins
    scheme_overrides: tuple = ()
    save_dir: str | None = None
    resume: bool = False
    offload_activations: bool = False  # keep hidden states in host memory
    on_save: str | None = None  # python snippet exec'd after each layer save
    verbose: bool = True
    mesh: object | None = None  # multi-device calibration: not ported (A14)


@torch.no_grad()
def _capture_taps(layer, cfg, hidden, positions, names, batch_size, taps_fn, place, offload):
    """One pass over all samples: X^T X per tap and the block outputs."""
    accs, outs = {}, []
    for start in range(0, hidden.shape[0], batch_size):
        out, taps = taps_fn(place(hidden[start:start + batch_size]), layer, cfg, positions)
        outs.append(out.cpu() if offload else out)
        for name in names:
            if name not in accs:
                accs[name] = XTXAccumulator.zeros(taps[name].shape[-1], device=taps[name].device)
            accs[name] = accs[name].add(taps[name])
    return accs, torch.cat(outs, dim=0)


@torch.no_grad()
def _propagate(layer, cfg, hidden, positions, batch_size, taps_fn, place, offload):
    outs = []
    for s in range(0, hidden.shape[0], batch_size):
        out = taps_fn(place(hidden[s:s + batch_size]), layer, cfg, positions)[0]
        outs.append(out.cpu() if offload else out)
    return torch.cat(outs, dim=0)


def quantize_model(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                   pipeline: QuantizePipelineConfig, *, val_input_ids: torch.Tensor | None = None,
                   taps_fn=llama.block_forward_with_taps) -> tuple[dict, dict]:
    """Quantize every block projection of ``params`` in place.

    input_ids [nsamples, seqlen] (any device; batches move to the params').
    Returns (params with reference-mode QuantizedLinear projections, stats:
    per-layer ``out_loss``, ``avg_bits``, per-projection ``projections``
    records (MSEs, Adam steps), and ``seconds`` by part: init, adam, beam,
    capture, finetune, propagate)."""
    if pipeline.mesh is not None:
        raise not_ported("calibration over a device mesh", "A14")
    scheme = pipeline.scheme
    dev = params["embed"].device
    seqlen = input_ids.shape[1]
    positions = torch.arange(seqlen, device=dev)[None, :]
    offload = pipeline.offload_activations
    place = lambda x: x.to(dev)
    bs = pipeline.batch_size

    def embed(ids):
        if ids is None:
            return None
        parts = []
        for s in range(0, ids.shape[0], bs):
            x = params["embed"][place(ids[s:s + bs]).long()]
            if cfg.gemma_norm:
                x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
            parts.append(x.cpu() if offload else x)
        return torch.cat(parts, dim=0)

    propagate = lambda layer, h: _propagate(layer, cfg, h, positions, bs, taps_fn, place, offload)
    hidden = embed(input_ids)
    val_hidden = embed(val_input_ids)

    stats = {"out_loss": [], "avg_bits": None, "projections": []}
    seconds = dict.fromkeys(("init", "adam", "beam", "capture", "finetune", "propagate"), 0.0)
    total_bits, total_params = 0.0, 0

    def timed(part, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(dev)
        seconds[part] += time.perf_counter() - t0
        return out

    for li, layer in enumerate(params["layers"]):
        if pipeline.resume and pipeline.save_dir:
            loaded = load_layer_checkpoint(pipeline.save_dir, li, device=dev)
            if loaded is not None:
                params["layers"][li] = layer = loaded
                hidden = timed("propagate", propagate, layer, hidden)
                if val_hidden is not None:
                    val_hidden = timed("propagate", propagate, layer, val_hidden)
                if pipeline.verbose:
                    print(f"layer {li}: loaded from checkpoint")
                continue

        quantizable = tuple(n for n, v in layer.items()
                            if isinstance(v, DenseLinear) and n not in pipeline.skip_names
                            and n != "moe_gate")
        if pipeline.true_sequential:
            groups = [tuple(n for n in g if n in quantizable) for g in SEQUENTIAL_GROUPS]
            leftover = tuple(n for n in quantizable if not any(n in g for g in groups))
            if leftover:
                groups.append(leftover)
        else:
            groups = [quantizable]

        targets = val_targets = None
        if val_hidden is not None:
            val_targets = timed("propagate", propagate, layer, val_hidden)

        for names in groups:
            if not names:
                continue
            accs, targets = timed("capture", _capture_taps, layer, cfg, hidden, positions, names,
                                  bs, taps_fn, place, offload)
            for name in names:
                dense = layer[name]
                sch = next((s for pat, s in pipeline.scheme_overrides if pat in name), scheme)
                ref_w = dense.weight.float()
                qw, wstats = quantize_weight(ref_w, accs.pop(name).mean, sch, pipeline.calib)
                for part in ("init", "adam", "beam"):
                    seconds[part] += wstats["seconds"][part]
                layer[name] = QuantizedLinear.from_aqlm(
                    AqlmWeight(codes=qw.codes, codebooks=qw.codebooks, scales=qw.scales,
                               bias=dense.bias, scheme=sch), mode="reference")
                del dense, ref_w
                bits = sch.estimate_nbits_per_parameter(
                    *qw.shape,
                    scale_nbits=pipeline.calib.scale_nbits,
                    codebook_value_nbits=pipeline.calib.codebook_value_nbits,
                    codebook_value_num_groups=pipeline.calib.codebook_value_num_groups,
                )
                numel = qw.out_features * qw.in_features
                total_bits += bits * numel
                total_params += numel
                stats["projections"].append({
                    "layer": li, "name": name, "init_mse": wstats["init_mse"],
                    "final_mse": wstats["final_mse"], "adam_steps": wstats["adam_steps"],
                    "bits": bits})
                if pipeline.verbose:
                    print(f"layer {li} {name}: mse={wstats['final_mse']:.3e} "
                          f"bits/param={bits:.3f}")
            del accs

            if pipeline.finetune is not None and pipeline.finetune.max_epochs > 0:
                layer = timed("finetune", finetune_block, layer, cfg, hidden, targets,
                              pipeline.finetune, valid_inps=val_hidden, valid_outs=val_targets,
                              taps_fn=taps_fn)
                params["layers"][li] = layer

        new_hidden = timed("propagate", propagate, layer, hidden)
        out_loss = float("nan")
        if targets is not None:
            nh, tg = new_hidden.float(), targets.float()
            out_loss = float(((nh - tg) ** 2).mean() / max(float((nh ** 2).mean()), 1e-6))
        stats["out_loss"].append(out_loss)
        hidden = new_hidden
        del targets, new_hidden
        if val_hidden is not None:
            val_hidden = timed("propagate", propagate, layer, val_hidden)

        if pipeline.save_dir:
            save_layer_checkpoint(pipeline.save_dir, li, layer)
            if pipeline.on_save:
                # a user callback after each layer save (preemptible workflows)
                exec(pipeline.on_save, {"layer_index": li, "save_dir": pipeline.save_dir})
        if pipeline.verbose:
            print(f"layer {li}: out_loss={out_loss:.3e}")

    stats["avg_bits"] = total_bits / max(total_params, 1)
    stats["seconds"] = seconds
    return params, stats
