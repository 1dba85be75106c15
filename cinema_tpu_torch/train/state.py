"""Train state and the MAE train step (port of cinema_tpu/train/state.py).

One step: draw the masks, forward in the model's compute dtype, gradients,
the fused AdamW update with its NaN guard. Nothing is read back to the
host: the loss, the gradient norm and the skip flag are returned as tensors
on the device, and a batch with a non-finite loss (reference train.py:138-140)
leaves parameters, moments and update count as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from cinema_tpu_torch.ops.masking import PatchMask
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState


@dataclass
class TrainState:
    """step: (micro-)batches seen, kept on the host (it does not depend on the
    data); params: the model, whose parameters the optimizer updates in
    place; opt_state: moments and update count; n_samples: samples seen."""

    step: int
    params: nn.Module
    opt_state: FusedAdamWState
    n_samples: int

    @classmethod
    def create(cls, model: nn.Module, tx: FusedAdamW) -> "TrainState":
        return cls(step=0, params=model, opt_state=tx.init(), n_samples=0)


def mask_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step's masks, a function of (seed, step) alone, so
    a resumed run draws the masks the uninterrupted run would have drawn."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))


def make_mae_train_step(
    model: nn.Module, tx: FusedAdamW, enc_mask_ratio: float, seed: int = 0
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the MAE pretrain step ``step_fn(state, batch, mask_dict=None) -> (state, metrics)``.

    ``batch`` holds per-view images (batch, *spatial, chans) on the model's
    device. ``mask_dict`` overrides the masks drawn from (seed, state.step).
    ``metrics`` are device tensors: the model's, ``grad_norm`` and
    ``skipped_nan`` (1.0 when the loss or the gradient norm was not finite and the batch was skipped).
    """
    params = list(model.parameters())
    if [id(p) for p in params] != [id(p) for p in tx.params]:
        raise ValueError("The optimizer was not built over this model's parameters.")

    def step_fn(
        state: TrainState, batch: Dict[str, torch.Tensor], mask_dict: Optional[Dict[str, PatchMask]] = None
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        first = next(iter(batch.values()))
        generator = mask_generator(seed, state.step, first.device)
        loss, _preds, _masks, metrics = model(batch, enc_mask_ratio, mask_dict, generator=generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        ok = torch.isfinite(loss.detach())
        metrics = dict(metrics)
        metrics["grad_norm"] = tx.step(grads, state.opt_state, ok)
        metrics["skipped_nan"] = (~(ok & torch.isfinite(metrics["grad_norm"]))).float()
        state.step += 1
        state.n_samples += first.shape[0]
        return state, metrics

    return step_fn
