"""Sliding-window patch extraction and aggregation, channels-last
(port of cinema_tpu/ops/window.py; reference cinema/transform.py).

The grid of patch starts is computed host-side from shapes; extraction is a
stack of slices and aggregation a chain of in-place slice adds.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def get_patch_grid(
    image_size: Sequence[int],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
) -> np.ndarray:
    """Start indices covering the image with a tail-aligned grid.

    Returns:
        (n_patches, n_dims) int array.
    """
    indices = []
    for img_dim, patch_dim, ovlp_dim in zip(image_size, patch_size, patch_overlap):
        if patch_dim > img_dim:
            raise ValueError(f"Patch size {patch_dim} should be <= image size {img_dim}.")
        if ovlp_dim >= patch_dim:
            raise ValueError(f"Patch overlap {ovlp_dim} must be < patch size {patch_dim}.")
        end = img_dim - patch_dim + 1
        idx = np.arange(0, end, patch_dim - ovlp_dim)
        if idx[-1] != end - 1:
            idx = np.append(idx, img_dim - patch_dim)
        indices.append(idx)
    return np.stack(np.meshgrid(*indices, indexing="ij"), axis=-1).reshape(-1, len(image_size))


def _slices(start: np.ndarray, size: Sequence[int]) -> tuple:
    return tuple(slice(int(s), int(s) + p) for s, p in zip(start, size))


def patch_grid_sample(
    x: torch.Tensor, start_indices: np.ndarray, patch_size: Sequence[int]
) -> torch.Tensor:
    """(*spatial[, ch]) -> (n_patches, *patch_size[, ch])."""
    return torch.stack([x[_slices(start, patch_size)] for start in np.asarray(start_indices)])


def aggregate_patches(
    patches: torch.Tensor, start_indices: np.ndarray, image_size: Sequence[int]
) -> torch.Tensor:
    """Average overlapping patches (n_patches, *patch_size, ch) into (*image_size, ch)."""
    n_patches, *patch_size, ch = patches.shape
    image_size = tuple(image_size)
    if n_patches != len(start_indices):
        raise ValueError(
            f"n_patches should be the same as start_indices, got {n_patches} and {len(start_indices)}."
        )
    if len(image_size) != len(patch_size):
        raise ValueError(
            f"image_size and patch_size should have the same length, "
            f"got image_size={image_size} and patches.shape={tuple(patches.shape)}."
        )
    out = torch.zeros((*image_size, ch), dtype=patches.dtype, device=patches.device)
    count = torch.zeros(image_size, dtype=torch.float32, device=patches.device)
    for i, start in enumerate(np.asarray(start_indices)):
        sl = _slices(start, patch_size)
        out[sl] += patches[i]
        count[sl] += 1.0
    return out / count[..., None]


def crop_start(image, target_shape: Sequence[int]):
    """Crop to target shape from the start (undo end-padding); numpy or torch."""
    if len(image.shape) != len(target_shape):
        raise ValueError(
            f"image.shape and target_shape should have the same length, "
            f"got {tuple(image.shape)} and {tuple(target_shape)}."
        )
    return image[tuple(slice(0, s) for s in target_shape)]
