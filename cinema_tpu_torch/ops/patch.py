"""Image -> patch tokens, channels-last (port of cinema_tpu/ops/patch.py:33-73).

Token order is row-major over the grid and each token's channels are laid
out (p0, ..., pn, c) with c fastest, as in the JAX package and the
reference checkpoints.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def patchify(image: torch.Tensor, patch_size: Sequence[int]) -> torch.Tensor:
    """(batch, *spatial, chans) -> (batch, n_patches, prod(patch_size) * chans)."""
    patch_size = tuple(patch_size)
    if len(patch_size) not in (2, 3, 4):
        raise ValueError(f"Patchify only supports 2D, 3D, and 4D images, got {len(patch_size)}D.")
    batch, *spatial, chans = image.shape
    if len(spatial) != len(patch_size):
        raise ValueError(f"Image rank {len(spatial)} does not match patch size rank {len(patch_size)}.")
    if any(s % p for s, p in zip(spatial, patch_size)):
        raise ValueError(f"Input size {tuple(spatial)} cannot be divided by patch size {patch_size}.")
    nd = len(patch_size)
    grid = [s // p for s, p in zip(spatial, patch_size)]
    shape = [batch]
    for g, p in zip(grid, patch_size):
        shape += [g, p]
    x = image.reshape(*shape, chans)
    # (b, g0, p0, ..., gn, pn, c) -> (b, g0..gn, p0..pn, c)
    perm = [0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)] + [1 + 2 * nd]
    return x.permute(perm).reshape(batch, math.prod(grid), math.prod(patch_size) * chans)
