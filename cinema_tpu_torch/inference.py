"""Sliding-window and chunked-video inference (port of cinema_tpu/inference.py;
reference cinema/segmentation/train.py:148-221).

All patches of a study form one batch, and a cine is served in fixed-size
frame chunks, one forward each. The overlaps are averaged as softmax
probabilities (segmentation) or as sigmoid probabilities (landmark heatmaps,
reference cinema/segmentation/landmark/train.py:135-208).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from cinema_tpu_torch.ops.window import aggregate_patches, get_patch_grid, patch_grid_sample

ForwardFn = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def _logit(p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    p = p.clamp(eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


def sliding_window_forward(
    forward_fn: ForwardFn,
    image_dict: Dict[str, torch.Tensor],
    patch_size_dict: Dict[str, Tuple[int, ...]],
    aggregation: str = "softmax",
) -> Dict[str, torch.Tensor]:
    """Patch one oversized view on a grid (overlap half a patch), forward all
    patches as one batch and average the overlaps in probability space.

    Args:
        forward_fn: batched forward, image_dict -> logits_dict (channels-last).
        image_dict: per-view (batch, *spatial, ch); at most one view larger
            than its patch size; other views are repeated per patch.
        patch_size_dict: per-view inference patch size.
        aggregation: ``"softmax"`` (exclusive classes: softmax-average, then
            log) or ``"sigmoid"`` (independent channels: sigmoid-average, then
            the logit, the probabilities clipped to [1e-7, 1 - 1e-7]; reference
            landmark/train.py:176-200). A view that is not patched is averaged
            over the patches in the same space.

    Returns:
        per-view (batch, *image_size, out_chans) float32 log-probabilities
        (softmax) or logits (sigmoid); the forward's logits unchanged when no
        view needs patching.
    """
    if aggregation not in ("softmax", "sigmoid"):
        raise ValueError(f"aggregation must be 'softmax' or 'sigmoid', got {aggregation!r}.")
    views = list(image_dict)
    for view, image in image_dict.items():
        if any(s < p for s, p in zip(image.shape[1:-1], patch_size_dict[view])):
            raise ValueError(
                f"For view {view}, image size {tuple(image.shape[1:-1])} is smaller than "
                f"patch size {patch_size_dict[view]}."
            )
    need_patch = {v: tuple(image_dict[v].shape[1:-1]) != tuple(patch_size_dict[v]) for v in views}
    if not any(need_patch.values()):
        return forward_fn(image_dict)
    if sum(need_patch.values()) > 1:
        raise ValueError(f"Only support patching on one view for now, but got {need_patch}.")
    batch = image_dict[views[0]].shape[0]

    view_to_patch = next(v for v, n in need_patch.items() if n)
    images = image_dict[view_to_patch]
    patch_size = tuple(patch_size_dict[view_to_patch])
    image_size = tuple(images.shape[1:-1])
    grid = get_patch_grid(image_size, patch_size, tuple(s // 2 for s in patch_size))
    patches = torch.stack([patch_grid_sample(img, grid, patch_size) for img in images])
    n_patches = patches.shape[1]
    patch_image_dict = {
        v: patches.reshape(batch * n_patches, *patches.shape[2:])
        if v == view_to_patch
        else torch.repeat_interleave(image_dict[v], n_patches, dim=0)
        for v in views
    }
    logits_dict = forward_fn(patch_image_dict)

    if aggregation == "softmax":
        to_probs, from_probs = (lambda x: torch.softmax(x, dim=-1)), torch.log
    else:
        to_probs, from_probs = torch.sigmoid, _logit
    out: Dict[str, torch.Tensor] = {}
    for view in views:
        probs = to_probs(logits_dict[view].float())
        probs = probs.reshape(batch, n_patches, *probs.shape[1:])
        if view == view_to_patch:
            out[view] = from_probs(torch.stack([aggregate_patches(p, grid, image_size) for p in probs]))
        else:
            out[view] = from_probs(probs.mean(dim=1))
    return out


def video_forward(
    forward_fn: Callable[[torch.Tensor], torch.Tensor], video: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Run a per-frame forward over a video in chunks of ``chunk`` frames.

    Args:
        forward_fn: (chunk, *spatial, ch) -> (chunk, *out).
        video: (n_frames, *spatial, ch); the last chunk is filled by repeating
            leading frames (wrap-indexing, so videos shorter than a chunk
            work too) and the extra outputs are dropped.

    Returns:
        (n_frames, *out).
    """
    n = video.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        video = torch.cat([video, video[torch.arange(n_pad, device=video.device) % n]], dim=0)
    outs = [forward_fn(video[i : i + chunk]) for i in range(0, video.shape[0], chunk)]
    return torch.cat(outs, dim=0)[:n]


def pad_to_multiple(
    image: np.ndarray, multiples: Sequence[int], mode: str = "constant"
) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """End-pad the spatial dims of (*spatial, ch) to multiples; returns (padded, original spatial shape)."""
    spatial = image.shape[:-1]
    pads = [(0, (int(np.ceil(s / m) * m) if m > 1 else s) - s) for s, m in zip(spatial, multiples)]
    return np.pad(image, [*pads, (0, 0)], mode=mode), tuple(spatial)
