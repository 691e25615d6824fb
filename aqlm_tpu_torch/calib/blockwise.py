"""Block-wise finetuning after quantization (PyTorch counterpart of
``aqlm_tpu.calib.blockwise``).

After a block's linears are quantized, every float tensor of the block
(codebooks, scales, norms, dense weights and biases left over) trains to
match the block's pre-quantization outputs under the token-mean MSE, with
Adam, per-epoch validation and early stopping; the best parameters by
validation loss are kept. The reference-mode projections dequantize through
``dequantize_weight``: on the card B13 in each forward and B14 in each
backward. ``torch.optim.Adam`` is optax's ``adam`` up to rounding (the same
eps placement).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from aqlm_tpu_torch.models import llama
from aqlm_tpu_torch.models.llama import ModelConfig
from aqlm_tpu_torch.pv.trainer import merge_trainable, split_trainable, tree_map

__all__ = ["BlockFinetuneConfig", "finetune_block"]


@dataclasses.dataclass
class BlockFinetuneConfig:
    """Defaults follow the reference CLI."""

    lr: float = 1e-5
    max_epochs: int = 5
    early_stop: int = 3
    batch_size: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    # recompute the block forward in the backward pass (the reference's
    # --use_checkpointing): trades recompute for activation memory
    use_checkpointing: bool = False
    verbose: bool = False


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) if x is not None else None, tree)
    return out


def finetune_block(layer: dict, cfg: ModelConfig, train_inps: torch.Tensor,
                   train_outs: torch.Tensor, config: BlockFinetuneConfig = BlockFinetuneConfig(),
                   *, valid_inps: torch.Tensor | None = None,
                   valid_outs: torch.Tensor | None = None,
                   taps_fn=llama.block_forward_with_taps) -> dict:
    """The finetuned block params (best by validation if validation data is
    given, else the last). Inputs and targets are [N, T, H]; batches move to
    the block's device as they are used (the arrays may live on the host)."""
    if config.max_epochs <= 0:
        return layer
    trainable, frozen = split_trainable(layer)
    trainable = tree_map(lambda x: None if x is None else x.detach().clone().requires_grad_(True),
                         trainable)
    params = _leaves(trainable)
    dev = params[0].device
    positions = torch.arange(train_inps.shape[1], device=dev)[None, :]
    opt = torch.optim.Adam(params, lr=config.lr, betas=(config.adam_beta1, config.adam_beta2),
                           eps=1e-8)
    block = merge_trainable(trainable, frozen)

    def fwd(x):
        return taps_fn(x, block, cfg, positions)[0]

    def mse(x, y):
        x = x.to(dev).float()
        if config.use_checkpointing and torch.is_grad_enabled():
            pred = torch.utils.checkpoint.checkpoint(fwd, x, use_reentrant=False)
        else:
            pred = fwd(x)
        return ((pred.float() - y.to(dev).float()) ** 2).mean()

    n = train_inps.shape[0]
    bs = min(config.batch_size, n)
    run_validation = valid_inps is not None and valid_outs is not None

    @torch.no_grad()
    def validate():
        losses = [float(mse(valid_inps[i:i + bs], valid_outs[i:i + bs]))
                  for i in range(0, valid_inps.shape[0], bs)]
        return float(np.mean(losses))

    snapshot = lambda: tree_map(lambda x: None if x is None else x.detach().clone(), trainable)
    best_loss = validate() if run_validation else float("inf")
    best = snapshot() if run_validation else None
    epochs_since_best = 0
    rng = np.random.RandomState(0)
    for epoch in range(config.max_epochs):
        order = rng.permutation(n)
        for start in range(0, n - bs + 1, bs):
            idx = torch.from_numpy(order[start:start + bs])
            opt.zero_grad(set_to_none=True)
            mse(train_inps[idx], train_outs[idx]).backward()
            opt.step()
        if run_validation:
            val = validate()
            if config.verbose:
                print(f"blockwise epoch {epoch}: val_mse={val:.3e}")
            if val < best_loss:
                best_loss, best, epochs_since_best = val, snapshot(), 0
            else:
                epochs_since_best += 1
                if epochs_since_best >= config.early_stop:
                    break
    if best is None:
        best = snapshot()
    return merge_trainable(best, frozen)
