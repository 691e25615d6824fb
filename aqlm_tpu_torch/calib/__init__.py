"""Calibration (PyTorch counterpart of ``aqlm_tpu.calib``): XTX capture,
k-means init, the beam search, the per-layer AQ engine, the block finetune
and the layer-streamed pipeline."""

from aqlm_tpu_torch.calib.beam_search_xtx import beam_search_optimal_codes, channelwise_squared_error
from aqlm_tpu_torch.calib.blockwise import BlockFinetuneConfig, finetune_block
from aqlm_tpu_torch.calib.engine import (
    CalibConfig,
    XTXAccumulator,
    compute_mse,
    init_quantized_weight,
    quantize_weight,
)
from aqlm_tpu_torch.calib.kmeans import find_nearest_cluster, fit_kmeans, fit_kmeans_1d
from aqlm_tpu_torch.calib.pipeline import SEQUENTIAL_GROUPS, QuantizePipelineConfig, quantize_model

__all__ = [
    "BlockFinetuneConfig",
    "finetune_block",
    "QuantizePipelineConfig",
    "SEQUENTIAL_GROUPS",
    "quantize_model",
    "beam_search_optimal_codes",
    "channelwise_squared_error",
    "CalibConfig",
    "XTXAccumulator",
    "compute_mse",
    "init_quantized_weight",
    "quantize_weight",
    "find_nearest_cluster",
    "fit_kmeans",
    "fit_kmeans_1d",
]
