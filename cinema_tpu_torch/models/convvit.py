"""ConvMAE conv stem before the ViT (port of cinema_tpu/models/convvit.py, the
dense DownsampleEncoder path; reference cinema/convvit.py:54-207).

The frozen sincos pos-embed is recomputed (numpy) and added as a constant,
not stored as a parameter; the masked and sparse stems belong to MAE
pretraining and are not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from cinema_tpu_torch.models.layers import ConvNormActBlock, Dense, MaskedConvBlock
from cinema_tpu_torch.models.vit import PatchEmbed
from cinema_tpu_torch.ops.pos_embed import get_nd_sincos_pos_embed, interpolate_pos_embed


def downsample_stack_sizes(
    image_size: Sequence[int],
    patch_size: Sequence[int],
    scale_factor: Sequence[int],
    n_conv_layers: int,
) -> Tuple[List[Tuple[int, ...]], Tuple[int, ...], Tuple[int, ...]]:
    """Shape bookkeeping for the conv stem.

    Returns:
        conv_sizes: spatial size after each conv level (n_conv_layers entries).
        eff_patch_size: effective patch size after conv layers + ViT patch embed.
        vit_grid: ViT grid size.
    """
    patch_sizes = [tuple(patch_size)] + [tuple(scale_factor)] * n_conv_layers
    size = tuple(image_size)
    conv_sizes = []
    for p in patch_sizes[:-1]:
        size = tuple(s // q for s, q in zip(size, p))
        conv_sizes.append(size)
    eff = tuple(math.prod(ps[i] for ps in patch_sizes) for i in range(len(image_size)))
    vit_grid = tuple(s // q for s, q in zip(size, patch_sizes[-1]))
    return conv_sizes, eff, vit_grid


def np_cumsum(xs: Sequence[int]) -> List[int]:
    """Cumulative sums of a python int list (split boundaries)."""
    out, acc = [], 0
    for x in xs:
        acc += x
        out.append(acc)
    return out


class DownsampleEncoder(nn.Module):
    """Per level: strided ConvNormActBlock + ``conv_n_blocks`` MaskedConvBlocks,
    then PatchEmbed + Linear + the sincos pos-embed (interpolated for
    off-size inputs)."""

    def __init__(self, image_size: Sequence[int], in_chans: int, patch_size: Sequence[int],
                 scale_factor: Sequence[int], conv_chans: Sequence[int], conv_n_blocks: int,
                 embed_dim: int, norm: str = "layer") -> None:
        super().__init__()
        nd = len(image_size)
        self.embed_dim = embed_dim
        self.patch_sizes = [tuple(patch_size)] + [tuple(scale_factor)] * len(conv_chans)
        conv_sizes, self.eff_patch_size, self.grid_size = downsample_stack_sizes(
            image_size, patch_size, scale_factor, len(conv_chans)
        )
        blocks = []
        chans = in_chans
        for ps, ch in zip(self.patch_sizes[:-1], conv_chans):
            block = nn.Module()
            block.patch_embed = ConvNormActBlock(nd, chans, ch, ps, stride=ps, norm=norm)
            block.conv = nn.ModuleList(MaskedConvBlock(nd, ch, norm=norm) for _ in range(conv_n_blocks))
            blocks.append(block)
            chans = ch
        self.conv_blocks = nn.ModuleList(blocks)
        self.patch_embed = PatchEmbed(
            conv_sizes[-1] if conv_sizes else tuple(image_size), self.patch_sizes[-1], chans, embed_dim
        )
        self.linear = Dense(embed_dim, embed_dim)
        self._pos_embed: dict = {}

    def pos_embed(self, grid_size: Tuple[int, ...], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """(1, prod(grid_size), E) sincos table, resized from the configured grid."""
        key = (grid_size, str(device), dtype)
        if key not in self._pos_embed:
            table = get_nd_sincos_pos_embed(self.embed_dim, self.patch_embed.grid_size)[None]
            table = interpolate_pos_embed(table, self.patch_embed.grid_size, grid_size)
            self._pos_embed[key] = torch.from_numpy(table).to(device=device, dtype=dtype)
        return self._pos_embed[key]

    def forward(self, image: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """image: (batch, in_chans, *spatial).

        Returns:
            skips: per-conv-level features (batch, chans_i, *size_i).
            x: (batch, n_patches, embed_dim) tokens with the pos-embed added.
        """
        grid_size = tuple(s // p for s, p in zip(image.shape[2:], self.eff_patch_size))
        skips = []
        x = image
        for block in self.conv_blocks:
            x = block.patch_embed(x)
            for conv in block.conv:
                x = conv(x)
            skips.append(x)
        x = self.linear(self.patch_embed(x))
        return skips, x + self.pos_embed(grid_size, x.device, x.dtype)
