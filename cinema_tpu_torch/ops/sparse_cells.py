"""Visible-cell bookkeeping for the ConvMAE stems (port of cinema_tpu/ops/sparse_cells.py).

With per-position norms the only op of the stem that crosses positions is
the 5^nd depthwise conv, and its input is zero at masked positions, so what
lies at masked positions never reaches a visible output. The stem therefore
runs on the gathered visible cells only, (batch * n_keep, C, *cell) tensors,
a quarter of the work at mask ratio 0.75, and is made dense only around
each depthwise conv:

- a "cell" is the image region one ViT-grid patch covers at the current stem
  level (convs with kernel == stride never cross cell boundaries);
- :func:`image_to_cells` / :func:`cells_to_image` move between the spatial
  and the cell-major layout, in the token order of ``patchify``;
- :func:`gather_cells` / :func:`scatter_cells` move between all cells and
  the visible ones (``PatchMask.keep_ids``);
- :class:`CellDenseCtx` is the densify/sparsify pair that MaskedConvBlock
  wraps around its depthwise conv.

These functions are channels-last, (batch, *spatial, C), like the JAX
package's; ``CellDenseCtx`` takes and returns the conv modules' (batch, C,
*spatial) and permutes around them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from cinema_tpu_torch.ops.patch import merge_cells, split_into_cells


def image_to_cells(x: torch.Tensor, grid_size: Tuple[int, ...]) -> torch.Tensor:
    """(batch, *spatial, C) -> (batch, n_cells, *cell, C), cells row-major over the grid."""
    spatial = tuple(x.shape[1:-1])
    if len(spatial) != len(grid_size):
        raise ValueError(f"grid rank {len(grid_size)} != spatial rank {len(spatial)}.")
    if any(s % g for s, g in zip(spatial, grid_size)):
        raise ValueError(f"spatial {spatial} not divisible by grid {tuple(grid_size)}.")
    return split_into_cells(x, tuple(s // g for s, g in zip(spatial, grid_size)))


def cells_to_image(cells: torch.Tensor, grid_size: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`image_to_cells`."""
    return merge_cells(cells, grid_size)


def gather_cells(cells: torch.Tensor, keep_ids: torch.Tensor) -> torch.Tensor:
    """(batch, n_cells, *cell, C), (batch, k) -> (batch, k, *cell, C)."""
    flat = cells.flatten(2)
    out = torch.gather(flat, 1, keep_ids[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(cells.shape[0], keep_ids.shape[1], *cells.shape[2:])


def scatter_cells(vis: torch.Tensor, keep_ids: torch.Tensor, n_cells: int) -> torch.Tensor:
    """(batch, k, *cell, C) -> (batch, n_cells, *cell, C), zeros at masked cells."""
    flat = vis.flatten(2)
    dense = flat.new_zeros((vis.shape[0], n_cells, flat.shape[-1]))
    dense.scatter_(1, keep_ids[..., None].expand(-1, -1, flat.shape[-1]), flat)
    return dense.reshape(vis.shape[0], n_cells, *vis.shape[2:])


class CellDenseCtx(NamedTuple):
    """Densify/sparsify pair around the ops that cross cells (the depthwise conv).

    Attributes:
        grid_size: ViT grid.
        keep_ids: (batch, k) visible cell ids.
    """

    grid_size: Tuple[int, ...]
    keep_ids: torch.Tensor

    @property
    def n_cells(self) -> int:
        return math.prod(self.grid_size)

    def densify(self, h: torch.Tensor) -> torch.Tensor:
        """(batch * k, C, *cell) -> (batch, C, *spatial) with zeros at masked cells."""
        batch, k = self.keep_ids.shape
        cells = h.movedim(1, -1).unflatten(0, (batch, k))
        dense = scatter_cells(cells, self.keep_ids, self.n_cells)
        return cells_to_image(dense, self.grid_size).movedim(-1, 1)

    def sparsify(self, dense: torch.Tensor) -> torch.Tensor:
        """(batch, C, *spatial) -> (batch * k, C, *cell)."""
        cells = image_to_cells(dense.movedim(1, -1), self.grid_size)
        return gather_cells(cells, self.keep_ids).flatten(0, 1).movedim(-1, 1)
