"""MAE patch masks with fixed-size index tensors (port of cinema_tpu/ops/masking.py).

The keep count is fixed by the mask ratio, so a mask is a pair of sorted
index tensors and every gather has a shape known before the data is: no
boolean indexing, hence no device-to-host sync in the training step. Sorted
ids keep the tokens in their original order, as ``x[~mask]`` of the
reference (cinema/mae/mae.py:550) does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch


class PatchMask(NamedTuple):
    """Per-sample random patch mask.

    Attributes:
        bool_mask: (batch, n_patches) bool, True = masked/removed.
        keep_ids: (batch, n_keep) int64, ascending, visible patch indices.
        mask_ids: (batch, n_masked) int64, ascending, masked patch indices.
    """

    bool_mask: torch.Tensor
    keep_ids: torch.Tensor
    mask_ids: torch.Tensor

    @property
    def n_patches(self) -> int:
        return self.bool_mask.shape[-1]

    @property
    def n_keep(self) -> int:
        return self.keep_ids.shape[-1]

    @property
    def n_masked(self) -> int:
        return self.mask_ids.shape[-1]


def n_keep_for_ratio(n_patches: int, mask_ratio: float) -> int:
    """Deterministic keep count (reference mae.py:59)."""
    return int(n_patches * (1 - mask_ratio))


def random_patch_mask(
    gen: Optional[torch.Generator],
    batch_size: int,
    n_patches: int,
    mask_ratio: float,
    device: Union[str, torch.device] = "cpu",
) -> PatchMask:
    """Per-sample random mask by ascending argsort of U[0, 1) noise, first
    ``n_keep`` kept (reference mae.py:30-65).

    The noise is drawn on ``gen``'s device (the CPU without one) and the mask
    is returned on ``device``.
    """
    if not 0 <= mask_ratio <= 1:
        raise ValueError(f"mask_ratio must be in [0, 1], got {mask_ratio}.")
    if mask_ratio == 0:
        return full_patch_mask(batch_size, n_patches, device)
    n_keep = n_keep_for_ratio(n_patches, mask_ratio)
    noise_device = gen.device if gen is not None else "cpu"
    noise = torch.rand((batch_size, n_patches), generator=gen, device=noise_device).to(device)
    ids_shuffle = torch.argsort(noise, dim=1)
    keep_ids = torch.sort(ids_shuffle[:, :n_keep], dim=1).values
    mask_ids = torch.sort(ids_shuffle[:, n_keep:], dim=1).values
    bool_mask = torch.ones((batch_size, n_patches), dtype=torch.bool, device=keep_ids.device)
    bool_mask.scatter_(1, keep_ids, False)
    return PatchMask(bool_mask=bool_mask, keep_ids=keep_ids, mask_ids=mask_ids)


def full_patch_mask(batch_size: int, n_patches: int, device: Union[str, torch.device] = "cpu") -> PatchMask:
    """Mask with ratio 0: everything visible, nothing masked."""
    return PatchMask(
        bool_mask=torch.zeros((batch_size, n_patches), dtype=torch.bool, device=device),
        keep_ids=torch.arange(n_patches, device=device).expand(batch_size, n_patches),
        mask_ids=torch.zeros((batch_size, 0), dtype=torch.int64, device=device),
    )


def gather_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather tokens by per-sample indices: the reference's
    ``x[~mask].reshape(batch, -1, dim)`` with a fixed output shape.

    Args:
        x: (batch, n_patches, dim), or (n_patches, dim) shared by the batch.
        ids: (batch, k) indices.

    Returns:
        (batch, k, dim).
    """
    if x.ndim == 2:
        return x[ids]
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def upsample_mask(mask: torch.Tensor, scale_factor: Sequence[int]) -> torch.Tensor:
    """Nearest-upsample a (batch, *grid) mask by ``scale_factor`` per axis (reference convvit.py:24-51)."""
    if mask.ndim != len(scale_factor) + 1:
        raise ValueError(
            f"mask must have the same number of dimensions as scale_factor except batch, "
            f"got {mask.ndim} and {len(scale_factor)}."
        )
    for axis, f in enumerate(scale_factor):
        if f != 1:
            mask = mask.repeat_interleave(f, dim=axis + 1)
    return mask


def visible_grid_mask(mask: PatchMask, grid_size: Sequence[int], scale_factor: Sequence[int]) -> torch.Tensor:
    """Visible (True = keep) mask upsampled from the ViT grid to a conv resolution:
    (batch, *(grid * scale)) bool."""
    vis = ~mask.bool_mask
    return upsample_mask(vis.reshape(vis.shape[0], *grid_size), scale_factor)
