"""Shared segmentation training and evaluation (port of cinema_tpu/tasks/segmentation/__init__.py;
reference cinema/segmentation/train.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.data import to_device
from cinema_tpu_torch.inference import sliding_window_forward
from cinema_tpu_torch.losses import segmentation_loss
from cinema_tpu_torch.metrics import segmentation_metrics
from cinema_tpu_torch.ops.window import crop_start

MetricsFn = Callable[[torch.Tensor, torch.Tensor, Sequence[float]], Dict[str, np.ndarray]]


def segmentation_loss_fn(
    model: nn.Module, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over views of the per-view segmentation loss (reference segmentation/train.py:106-145).

    The batch holds ``{view}_image`` (b, *s, ch) and ``{view}_label`` (b, *s); the metrics are the
    per-view losses' under ``{view}_`` and the mean ``loss``.
    """
    views = sorted(k[: -len("_image")] for k in batch if k.endswith("_image"))
    logits_dict = model({v: batch[f"{v}_image"] for v in views})
    metrics: Dict[str, torch.Tensor] = {}
    losses = []
    for view, logits in logits_dict.items():
        loss_view, metrics_view = segmentation_loss(logits, batch[f"{view}_label"])
        losses.append(loss_view)
        metrics.update({f"{view}_{k}": v for k, v in metrics_view.items()})
    loss = sum(losses) / len(losses)
    metrics["loss"] = loss
    return loss, metrics


def _scalar(x: Any) -> int:
    return int(np.asarray(x).reshape(-1)[0])


def segmentation_eval_batch(
    forward: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
    batch: Mapping[str, Any],
    patch_size_dict: Dict[str, Tuple[int, ...]],
    spacing_dict: Dict[str, Tuple[float, ...]],
    metrics_fn: Optional[MetricsFn] = segmentation_metrics,
    z_bucket: Optional[int] = None,
    per_sample: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Union[Dict[str, float], List[Dict[str, float]]]]:
    """Evaluate one batch of a study: sliding window, crop of the padding, metrics
    (reference segmentation/train.py:289-358).

    Args:
        forward: batched forward, image_dict -> logits_dict (channels-last).
        batch: ``{view}_image`` (b, *s, ch) and ``{view}_label`` (b, *s) tensors on the forward's
            device; ``{view}_width``, ``{view}_height`` and ``n_slices``, the size before padding,
            as anything numpy reads (the first entry is used).
        metrics_fn: (log-probabilities, labels, spacing) -> per metric name a (batch,) array; the
            default is the ED/ES tasks' suite, EMIDEC and MyoPS2020 pass their grouped-class metrics.
            None returns no metrics.
        z_bucket: when set, the z axis of a 3-D view is zero-padded to
            ``max(patch_z, ceil(z / z_bucket) * z_bucket)`` first, as the JAX package does so that
            studies of one bucket share one compiled program; the predictions are cropped back.
        per_sample: the batch holds several frames of one study (one size); return one metric
            row per frame instead of the row of frame 0.

    Returns:
        the cropped (b, width, height[, n_slices], out_chans) log-probabilities (logits where no
        patching was needed) per view, and the metrics: per view under ``{view}_`` and their mean
        across views; ``{}`` (``[]`` with ``per_sample``) without labels.
    """
    views = list(patch_size_dict)
    image_dict = {v: batch[f"{v}_image"] for v in views}
    if z_bucket:
        for v in views:
            if len(patch_size_dict[v]) != 3:
                continue
            z = image_dict[v].shape[3]
            z_pad = max(patch_size_dict[v][2], -(-z // z_bucket) * z_bucket)
            if z_pad != z:
                image_dict[v] = F.pad(image_dict[v], (0, 0, 0, z_pad - z))
    logits_dict = sliding_window_forward(forward, image_dict, patch_size_dict)

    def crop_to_original(x: torch.Tensor, view: str) -> torch.Tensor:
        size = [_scalar(batch[f"{view}_width"]), _scalar(batch[f"{view}_height"])]
        if len(patch_size_dict[view]) == 3:
            size.append(_scalar(batch["n_slices"]))
        return crop_start(x, (x.shape[0], *size, x.shape[-1]))

    logits_dict = {v: crop_to_original(logits_dict[v], v) for v in views}
    if metrics_fn is None or f"{views[0]}_label" not in batch:
        return logits_dict, ([] if per_sample else {})

    per_view: Dict[str, Dict[str, np.ndarray]] = {}
    metric_keys: List[str] = []
    for view in views:
        label = crop_start(batch[f"{view}_label"], logits_dict[view].shape[:-1])
        metrics_view = metrics_fn(logits_dict[view], label, spacing_dict[view])
        metric_keys = list(metrics_view)
        per_view[view] = {k: np.asarray(v, dtype=np.float64).reshape(-1) for k, v in metrics_view.items()}

    def row(i: int) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for view in views:
            for k, v in per_view[view].items():
                out[f"{view}_{k}"] = float(v[i])
        for k in metric_keys:
            out[k] = float(np.mean([out[f"{view}_{k}"] for view in views]))
        return out

    if per_sample:
        return logits_dict, [row(i) for i in range(next(iter(logits_dict.values())).shape[0])]
    return logits_dict, row(0)


def patch_and_spacing_dicts(config: Config) -> Tuple[Dict[str, Tuple[int, ...]], Dict[str, Tuple[float, ...]]]:
    """Per view of ``config.model.views``: its patch size and its voxel spacing."""
    views = [config.model.views] if isinstance(config.model.views, str) else list(config.model.views)

    def view_cfg(v: str) -> Config:
        if v == "sax":
            return config.data.sax
        return config.data.lax if "lax" in config.data else config.data[v]

    return {v: tuple(view_cfg(v).patch_size) for v in views}, {v: tuple(view_cfg(v).spacing) for v in views}


@torch.no_grad()
def segmentation_eval_dataloader(model: nn.Module, dataloader: Any, config: Config,
                                 metrics_fn: MetricsFn = segmentation_metrics) -> Dict[str, float]:
    """The ``nanmean`` of every metric of ``metrics_fn`` over a batch-1 loader (reference
    segmentation/train.py:361-400); ``eval.z_bucket`` (default 4) as :func:`segmentation_eval_batch`
    says. The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    patch_size_dict, spacing_dict = patch_and_spacing_dicts(config)
    z_bucket = config.get("eval", {}).get("z_bucket", 4)
    all_metrics: Dict[str, List[float]] = {}
    for batch in dataloader.epoch(0):
        tensors = to_device({k: v for k, v in batch.items() if k.endswith(("_image", "_label"))}, device)
        _, metrics = segmentation_eval_batch(model, {**batch, **tensors}, patch_size_dict, spacing_dict, metrics_fn,
                                             z_bucket=z_bucket)
        for k, v in metrics.items():
            all_metrics.setdefault(k, []).append(v)
    return {k: float(np.nanmean(v)) for k, v in all_metrics.items()}
