"""Image <-> patch tokens, channels-last (port of cinema_tpu/ops/patch.py).

Token order is row-major over the grid and each token's channels are laid
out (p0, ..., pn, c) with c fastest, as in the JAX package and the
reference checkpoints. These functions keep the JAX package's channels-last
layout (batch, *spatial, chans); the conv modules, whose tensors are
(batch, chans, *spatial), permute around them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _check_divisible(spatial: Sequence[int], patch_size: Sequence[int]) -> None:
    if len(spatial) != len(patch_size):
        raise ValueError(f"Image rank {len(spatial)} does not match patch size rank {len(patch_size)}.")
    if any(s % p for s, p in zip(spatial, patch_size)):
        raise ValueError(f"Input size {tuple(spatial)} cannot be divided by patch size {tuple(patch_size)}.")


def patchify(image: torch.Tensor, patch_size: Sequence[int]) -> torch.Tensor:
    """(batch, *spatial, chans) -> (batch, n_patches, prod(patch_size) * chans)."""
    patch_size = tuple(patch_size)
    if len(patch_size) not in (2, 3, 4):
        raise ValueError(f"Patchify only supports 2D, 3D, and 4D images, got {len(patch_size)}D.")
    batch, *spatial, chans = image.shape
    _check_divisible(spatial, patch_size)
    cells = split_into_cells(image, patch_size)
    return cells.reshape(batch, cells.shape[1], math.prod(patch_size) * chans)


def split_into_cells(image: torch.Tensor, cell_size: Sequence[int]) -> torch.Tensor:
    """(batch, *spatial, C) -> (batch, n_cells, *cell_size, C), row-major over the cell grid.

    The one place that holds the grid-split permutation: patch tokens and
    the sparse stem's visible cells must agree on it. Divisibility is the
    caller's contract.
    """
    batch, *spatial, chans = image.shape
    nd = len(cell_size)
    grid = [s // c for s, c in zip(spatial, cell_size)]
    shape = [batch]
    for g, c in zip(grid, cell_size):
        shape += [g, c]
    x = image.reshape(*shape, chans)
    # (b, g0, p0, ..., gn, pn, c) -> (b, g0..gn, p0..pn, c)
    perm = [0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)] + [1 + 2 * nd]
    return x.permute(perm).reshape(batch, math.prod(grid), *cell_size, chans)


def merge_cells(cells: torch.Tensor, grid_size: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`split_into_cells`: (batch, n_cells, *cell, C) -> (batch, *spatial, C)."""
    batch, chans = cells.shape[0], cells.shape[-1]
    grid_size = tuple(grid_size)
    nd = len(grid_size)
    cell = tuple(cells.shape[2:-1])
    x = cells.reshape(batch, *grid_size, *cell, chans)
    # (b, g0..gn, p0..pn, c) -> (b, g0, p0, ..., gn, pn, c)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm.append(1 + 2 * nd)
    spatial = tuple(g * c for g, c in zip(grid_size, cell))
    return x.permute(perm).reshape(batch, *spatial, chans)


def unpatchify(x: torch.Tensor, patch_size: Sequence[int], grid_size: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`patchify`: (batch, n_patches, prod(patch_size) * chans) -> (batch, *spatial, chans)."""
    patch_size = tuple(patch_size)
    grid_size = tuple(grid_size)
    if len(patch_size) != len(grid_size):
        raise ValueError(f"Patch size {patch_size} and grid size {grid_size} do not match.")
    if len(patch_size) not in (2, 3, 4):
        raise ValueError(f"Unpatchify only supports 2D, 3D, and 4D images, got {len(patch_size)}D.")
    batch, n_patches, tok_chans = x.shape
    if n_patches != math.prod(grid_size):
        raise ValueError(f"Number of patches {n_patches} != product of grid size {math.prod(grid_size)}.")
    if tok_chans % math.prod(patch_size) != 0:
        raise ValueError(f"Token channels {tok_chans} not divisible by patch volume {math.prod(patch_size)}.")
    chans = tok_chans // math.prod(patch_size)
    return merge_cells(x.reshape(batch, n_patches, *patch_size, chans), grid_size)
