"""Optimizer and LR schedule (port of cinema_tpu/train/optim.py; reference cinema/optim.py).

- the LR schedule is a function of the update count, evaluated on the device
  inside the step;
- BEiT layer-wise LR decay is a per-parameter scale multiplied into the
  update, and freezing is a zero scale: no param groups;
- no GradScaler: bf16 compute with f32 parameters and optimizer state needs
  no loss scaling.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from cinema_tpu_torch.models.convvit import get_layer_id_for_vit
from cinema_tpu_torch.train.fused_optim import FusedAdamW


def warmup_cosine_schedule(
    lr: float, min_lr: float, warmup_steps: float, max_n_steps: float
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup + half-cosine decay to min_lr (reference optim.py:21-52).

    ``step`` is the optimizer's update count (a tensor or a number); warmup
    and max are in the same unit. Returns a float32 tensor on step's device.
    """

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = lr * step / max(warmup_steps, 1e-8)
        progress = (step - warmup_steps) / max(max_n_steps - warmup_steps, 1e-8)
        cos = min_lr + (lr - min_lr) * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def layer_decay_scales(params: Mapping[str, torch.Tensor], layer_decay: float, n_blocks: int) -> Dict[str, float]:
    """Per-parameter LR scale from the BEiT layer ids (reference convvit.py:740-810), by state_dict key."""
    n_layers = n_blocks + 1
    scales = [layer_decay ** (n_layers - i) for i in range(n_layers + 1)]
    return {key: scales[get_layer_id_for_vit(key, n_layers)] for key in params}


def build_optimizer(
    params: Mapping[str, torch.Tensor],
    lr: float,
    min_lr: float = 0.0,
    warmup_steps: float = 0,
    max_n_steps: float = 1,
    betas: tuple = (0.9, 0.95),
    weight_decay: float = 0.05,
    clip_grad: Optional[float] = None,
    layer_decay: Optional[float] = None,
    n_blocks: int = 0,
    freeze_mask: Optional[Mapping[str, bool]] = None,
    accum_steps: int = 1,
) -> FusedAdamW:
    """AdamW with warmup-cosine LR, optional layer decay, freezing and accumulation.

    Clip by the global norm before the update (reference optim.py:204-215),
    decoupled weight decay that skips 1-D parameters (convvit.py:776-781),
    per-parameter LR scales (optim.py:47-51).

    Args:
        params: name -> parameter (``dict(model.named_parameters())``); updated in place by the optimizer.
        freeze_mask: name -> True for a frozen parameter (its update is zeroed).
        accum_steps: micro-batches whose mean gradient makes one update.
    """
    # PyYAML reads '1e-3' (no decimal point) as a string
    lr, min_lr = float(lr), float(min_lr)
    warmup_steps, max_n_steps = float(warmup_steps), float(max_n_steps)
    scales = {key: 1.0 for key in params}
    if layer_decay is not None:
        scales = layer_decay_scales(params, float(layer_decay), n_blocks)
    if freeze_mask is not None:
        scales = {key: 0.0 if freeze_mask[key] else s for key, s in scales.items()}
    return FusedAdamW(
        list(params.values()),
        schedule=warmup_cosine_schedule(lr, min_lr, warmup_steps, max_n_steps),
        b1=float(betas[0]),
        b2=float(betas[1]),
        weight_decay=float(weight_decay),
        wd_mask=[p.ndim > 1 for p in params.values()],
        clip_grad=None if clip_grad is None else float(clip_grad),
        scales=[scales[key] for key in params],
        accum_steps=accum_steps,
    )


def get_n_accum_steps(batch_size: int, batch_size_per_device: int, world_size: int) -> int:
    """Gradient accumulation count (reference optim.py:122-143)."""
    batch_size_per_step = batch_size_per_device * world_size
    if batch_size_per_step > batch_size:
        raise ValueError(f"batch_size_per_step {batch_size_per_step} should be less than batch_size {batch_size}.")
    if batch_size % batch_size_per_step != 0:
        raise ValueError(f"batch_size {batch_size} should be divisible by batch_size_per_step {batch_size_per_step}.")
    return batch_size // batch_size_per_step
