"""Train state, the MAE train step and the supervised train step (port of cinema_tpu/train/state.py).

One step: draw the masks, forward in the model's compute dtype, gradients,
the fused AdamW update with its NaN guard. Nothing is read back to the
host: the loss, the gradient norm and the skip flag are returned as tensors
on the device, and a batch with a non-finite loss (reference train.py:138-140)
leaves parameters, moments, update count and the running statistics of the
model's BatchNorms as they were.

A distributed run passes the model's ``parallel.mesh.Parallel``: the
gradients are reduced over the ranks, a batch is skipped on every rank where
any rank's loss is not finite, the metrics are the data ranks' mean, and
``n_samples`` counts the rows of every data rank. Without it a step is what
it was.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from cinema_tpu_torch import trace
from cinema_tpu_torch.models.layers import sampling_from
from cinema_tpu_torch.ops.masking import PatchMask
from cinema_tpu_torch.train.fused_optim import FusedAdamW, FusedAdamWState

if TYPE_CHECKING:
    from cinema_tpu_torch.parallel.mesh import Parallel


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
    model: nn.Module, tx: FusedAdamW, enc_mask_ratio: float, seed: int = 0, parallel: Optional["Parallel"] = None
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the MAE pretrain step ``step_fn(state, batch, mask_dict=None) -> (state, metrics)``.

    ``batch`` holds per-view images (batch, *spatial, chans) on the model's
    device. ``mask_dict`` overrides the masks drawn from (seed, state.step);
    in a data-parallel run the masks of the whole batch are drawn and a rank
    takes its rows, those the single-process step would give its images.
    ``metrics`` are device tensors: the model's, ``grad_norm`` and
    ``skipped_nan`` (1.0 when the loss or the gradient norm was not finite and the batch was skipped).
    """
    params = _optimizer_params(model, tx, parallel)

    def step_fn(
        state: TrainState, batch: Dict[str, torch.Tensor], mask_dict: Optional[Dict[str, PatchMask]] = None
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace.span("step", request=state.step):
            first = next(iter(batch.values()))
            with trace.span("step.forward"):
                generator = mask_generator(seed, state.step, first.device)
                if mask_dict is None and parallel is not None and parallel.n_data > 1:
                    rows = first.shape[0]
                    whole = model.draw_masks(batch, enc_mask_ratio, generator, rows * parallel.n_data)
                    own = slice(parallel.data_rank * rows, (parallel.data_rank + 1) * rows)
                    mask_dict = {v: PatchMask(*(t[own] for t in m)) for v, m in whole.items()}
                loss, _preds, _masks, metrics = model(batch, enc_mask_ratio, mask_dict, generator=generator)
            return _guarded_update(state, tx, params, loss, metrics, first.shape[0], parallel, model)

    return step_fn


def _optimizer_params(model: nn.Module, tx: FusedAdamW, parallel: Optional["Parallel"] = None) -> list:
    params = list(model.parameters())
    if parallel is not None and parallel.fsdp:  # the optimizer holds local shards, fetched anew each step
        ok = [tuple(p.shape) for p in parallel.optimizer_params(model)] == [tuple(p.shape) for p in tx.params]
    else:
        ok = [id(p) for p in params] == [id(p) for p in tx.params]
    if not ok:
        raise ValueError("The optimizer was not built over this model's parameters.")
    return params


def _guarded_update(
    state: TrainState, tx: FusedAdamW, params: list, loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
    batch_size: int, parallel: Optional["Parallel"] = None, model: Optional[nn.Module] = None,
    saved_buffers: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Gradients of ``loss``, the guarded optimizer step, the counters. Each (buffer, value before
    the forward) of ``saved_buffers`` gets its old value back where the batch is skipped."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    with trace.span("step.backward"):
        if parallel is None:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            ok, targets, rows = torch.isfinite(loss.detach()), None, batch_size
        else:
            grads = parallel.gradients(loss, model)
            ok, metrics = parallel.all_finite(loss), parallel.mean_metrics(metrics)
            targets = parallel.optimizer_params(model) if parallel.fsdp else None
            rows = batch_size * parallel.n_data
    with trace.span("step.update"):
        metrics["grad_norm"] = tx.step(grads, state.opt_state, ok, targets)
        metrics["skipped_nan"] = (~(ok & torch.isfinite(metrics["grad_norm"]))).float()
        if saved_buffers:
            skipped = metrics["skipped_nan"].bool()
            with torch.no_grad():
                for b, old in saved_buffers:
                    b.copy_(torch.where(skipped, old, b))
            if parallel is not None and parallel.n_data > 1:
                parallel.broadcast_buffers(model)
    state.step += 1
    state.n_samples += rows
    return state, metrics


def make_supervised_train_step(
    model: nn.Module,
    tx: FusedAdamW,
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    seed: int = 0,
    parallel: Optional["Parallel"] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the supervised step ``step_fn(state, batch) -> (state, metrics)``.

    ``loss_fn(model, batch) -> (loss, metrics)`` runs the model in train
    mode; drop-path and dropout draw from a generator that is a function of
    (seed, state.step) alone. ``metrics`` are device tensors: the loss
    function's, ``grad_norm`` and ``skipped_nan``.

    The model's buffers (the running statistics of the baselines' BatchNorms)
    change in the forward pass, before the guard has seen the loss: they are
    saved before it and put back where the batch is skipped, as the JAX
    package's step keeps the old ``batch_stats`` under its guard. In a data-parallel run
    they are data rank 0's after the step (DDP's ``broadcast_buffers``).
    """
    params = _optimizer_params(model, tx, parallel)
    buffers = list(model.buffers())

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace.span("step", request=state.step):
            first = next(iter(batch.values()))
            with trace.span("step.forward"):
                model.train()
                saved = [(b, b.clone()) for b in buffers]
                with sampling_from(mask_generator(seed, state.step, first.device)):
                    loss, metrics = loss_fn(model, batch)
            return _guarded_update(state, tx, params, loss, metrics, first.shape[0], parallel, model, saved)

    return step_fn
