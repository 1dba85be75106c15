"""Shared classification training and evaluation (port of cinema_tpu/tasks/classification/__init__.py;
reference cinema/classification/train.py)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config
from cinema_tpu_torch.factory import get_convvit_model, resolve_device
from cinema_tpu_torch.losses import classification_loss
from cinema_tpu_torch.metrics import classification_metrics
from cinema_tpu_torch.models.resnet import ResNet
from cinema_tpu_torch.ops.window import get_patch_grid, patch_grid_sample


def get_classification_model(
    config: Config, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> nn.Module:
    """The model ``config.model.name`` names (reference classification/train.py:25-81): ConvViT or ResNet,
    in eval mode on ``device``.

    The ResNet is built as the JAX package builds it, from ``model.resnet.layers`` and
    ``layer_inplanes`` alone (basic blocks whatever ``depth`` says); it is 3-D for ``sax`` and 2-D for a
    ``lax_*`` view, and takes ``model.n_frames`` frames of ``in_chans`` channels stacked as channels, the
    channels of the task's items. Its head has one output per class of ``data.class_column``, one for
    ``data.regression_column``, else ``model.out_chans``."""
    if config.model.name == "convvit":
        return get_convvit_model(config, dtype=dtype, device=device)
    if config.model.name == "resnet":
        device = resolve_device(device)
        views = [config.model.views] if isinstance(config.model.views, str) else list(config.model.views)
        if len(views) > 1:
            raise ValueError("ResNet only supports single view.")
        if "class_column" in config.data:
            out_chans = len(config.data[config.data.class_column])
        elif "regression_column" in config.data:
            out_chans = 1
        else:
            out_chans = config.model.out_chans
        data = config.data.sax if views[0] == "sax" else config.data.lax
        model = ResNet(
            nd=3 if views[0] == "sax" else 2,
            in_chans=config.model.get("n_frames", 1) * data.in_chans,
            out_chans=out_chans,
            layers=tuple(config.model.resnet.get("layers", (2, 2, 2, 2))),
            layer_inplanes=tuple(config.model.resnet.layer_inplanes),
            dtype=dtype,
        )
        return model.to(device).eval()
    raise ValueError(f"Invalid model name {config.model.name}.")


def batch_images(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The per-view images of a batch: its ``{view}_image`` entries, by view."""
    return {k[: -len("_image")]: batch[k] for k in sorted(batch) if k.endswith("_image")}


def classification_loss_fn(
    model: nn.Module, batch: Dict[str, torch.Tensor], label_smoothing: float = 0.1
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smoothed cross entropy on the model's logits (reference classification/train.py:84-113)."""
    return classification_loss(model(batch_images(batch)), batch["label"], label_smoothing)


def patched_forward(
    forward: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    image_dict: Dict[str, torch.Tensor],
    patch_size_dict: Dict[str, Tuple[int, ...]],
) -> Tuple[torch.Tensor, bool]:
    """``forward`` on the images, or where one view is larger than its patch size, on the
    half-overlapping patches of that view (batch size 1), the other views repeated.

    Returns:
        (the (batch or n_patches, out) outputs, whether patches were taken).
    """
    views = list(image_dict)
    need_patch = {v: tuple(image_dict[v].shape[1:-1]) != tuple(patch_size_dict[v]) for v in views}
    if not any(need_patch.values()):
        return forward(image_dict), False
    if sum(need_patch.values()) > 1:
        raise ValueError(f"Only support patching on one view for now, but got {need_patch}.")
    if image_dict[views[0]].shape[0] != 1:
        raise ValueError("Expected batch size 1 for patching.")
    view_to_patch = next(v for v, n in need_patch.items() if n)
    image = image_dict[view_to_patch][0]
    patch_size = tuple(patch_size_dict[view_to_patch])
    grid = get_patch_grid(image.shape[:-1], patch_size, tuple(s // 2 for s in patch_size))
    patches = patch_grid_sample(image, grid, patch_size)
    patch_image_dict = {
        v: patches if v == view_to_patch else image_dict[v].expand(patches.shape[0], *image_dict[v].shape[1:])
        for v in views
    }
    return forward(patch_image_dict), True


def classification_forward(
    forward: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    image_dict: Dict[str, torch.Tensor],
    patch_size_dict: Dict[str, Tuple[int, ...]],
) -> torch.Tensor:
    """Logits, or over patches the log of the mean softmax (reference classification/train.py:116-180)."""
    logits, patched = patched_forward(forward, image_dict, patch_size_dict)
    if not patched:
        return logits
    return torch.softmax(logits.float(), dim=-1).mean(dim=0, keepdim=True).log()


def view_patch_sizes(config: Config) -> Dict[str, Tuple[int, ...]]:
    views = [config.model.views] if isinstance(config.model.views, str) else list(config.model.views)
    return {v: tuple((config.data.sax if v == "sax" else config.data.lax).patch_size) for v in views}


@torch.no_grad()
def classification_eval_dataloader(
    model: nn.Module, dataloader: Iterable[Dict[str, np.ndarray]], config: Config
) -> Dict[str, float]:
    """Per-sample probabilities over a batch-1 loader, then the whole metric suite
    (reference classification/train.py:298-360). The model is left in eval mode."""
    model.eval()
    device = next(model.parameters()).device
    patch_size_dict = view_patch_sizes(config)
    true_labels: List[int] = []
    probs: List[torch.Tensor] = []
    for batch in dataloader.epoch(0):
        image_dict = {v: torch.from_numpy(batch[f"{v}_image"]).to(device) for v in patch_size_dict}
        logits = classification_forward(model, image_dict, patch_size_dict)
        probs.append(torch.softmax(logits.float(), dim=-1)[0])
        true_labels.append(int(np.asarray(batch["label"]).reshape(-1)[0]))
    pred_probs = torch.stack(probs).cpu().numpy()  # the evaluation's one read from the device
    return classification_metrics(np.asarray(true_labels), pred_probs.argmax(axis=-1), pred_probs)
