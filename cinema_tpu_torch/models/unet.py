"""Residual UNet baseline for segmentation (port of cinema_tpu/models/unet.py; reference
cinema/segmentation/unet.py).

One view, 2-D or 3-D, a dict of channels-last images in and a dict of channels-last logits out.
Every residual block's output is kept as a skip and added back at the mirrored block of the
decoder; where an upsampled tensor is smaller than its skip (an odd size), it is end-padded
with zeros to the skip's size (reference unet.py:211-218). The module names are the reference
checkpoint's (``encoder.blocks.0.conv.1.conv2.weight``, ``decoder.blocks.3.up.weight``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from cinema_tpu_torch.models.layers import Conv, ConvNormActBlock, ConvResBlock, ConvTranspose

KernelSize = Union[int, Sequence[int]]


def _as_tuple(v: KernelSize, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Level(nn.Module):
    """One resolution of the encoder or the decoder: ``n_blocks`` residual blocks at ``chans``, then the
    resampling conv ``resample`` (``down`` or ``up``) to ``next_chans`` unless it is the last level."""

    def __init__(self, nd: int, chans: int, n_blocks: int, kernel_size: int, dropout: float, norm: str,
                 resample: str = "", next_chans: int = 0, kernel: Tuple[int, ...] = ()) -> None:
        super().__init__()
        self.conv = nn.ModuleList([ConvResBlock(nd, chans, chans, kernel_size, dropout, norm) for _ in range(n_blocks)])
        if resample == "down":
            self.down = Conv(nd, chans, next_chans, kernel, stride=kernel)
        elif resample == "up":
            self.up = ConvTranspose(nd, chans, next_chans, kernel)


class DownsampleEncoder(nn.Module):
    """The encoder (reference unet.py:12-114): a conv-norm-GELU stem to ``chans[0]``, then per level its
    residual blocks and a strided conv (kernel = stride = ``patch_size`` after the first level,
    ``scale_factor`` after the others). Returns every block's output, the stem's first."""

    def __init__(self, nd: int, in_chans: int, chans: Sequence[int], patch_size: KernelSize = 2,
                 scale_factor: KernelSize = 2, norm: str = "instance", kernel_size: int = 3, n_blocks: int = 2,
                 dropout: float = 0.0) -> None:
        super().__init__()
        chans = tuple(chans)
        self.in_conv = ConvNormActBlock(nd, in_chans, chans[0], kernel_size, norm=norm, padding="same")
        self.blocks = nn.ModuleList([
            _Level(nd, ch, n_blocks, kernel_size, dropout, norm)
            if i == len(chans) - 1 else
            _Level(nd, ch, n_blocks, kernel_size, dropout, norm, "down", chans[i + 1],
                   _as_tuple(patch_size if i == 0 else scale_factor, nd))
            for i, ch in enumerate(chans)
        ])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.in_conv(x)
        embeddings = [x]
        for i, level in enumerate(self.blocks):
            for block in level.conv:
                x = block(x)
                embeddings.append(x)
            if i < len(self.blocks) - 1:
                x = level.down(x)
                embeddings.append(x)
        return embeddings


class UpsampleDecoder(nn.Module):
    """The decoder (reference unet.py:117-219): per level from the coarsest, its residual blocks, each
    output plus the mirrored skip, then a transposed conv up (kernel = stride = ``patch_size`` into the
    finest level, ``scale_factor`` into the others), end-padded to its skip's size and plus that skip."""

    def __init__(self, nd: int, chans: Sequence[int], patch_size: KernelSize = 2, scale_factor: KernelSize = 2,
                 norm: str = "instance", kernel_size: int = 3, n_blocks: int = 2, dropout: float = 0.0) -> None:
        super().__init__()
        chans = tuple(chans)
        n = len(chans)
        self.blocks = nn.ModuleList([
            _Level(nd, ch, n_blocks, kernel_size, dropout, norm)
            if i == n - 1 else
            _Level(nd, ch, n_blocks, kernel_size, dropout, norm, "up", chans[-i - 2],
                   _as_tuple(patch_size if i == n - 2 else scale_factor, nd))
            for i, ch in enumerate(chans[::-1])
        ])

    def forward(self, embeddings: List[torch.Tensor]) -> torch.Tensor:
        embeddings = list(embeddings)
        x = embeddings.pop()
        for i, level in enumerate(self.blocks):
            for block in level.conv:
                x = block(x) + embeddings.pop()
            if i < len(self.blocks) - 1:
                x = level.up(x)
                skipped = embeddings.pop()
                if x.shape != skipped.shape:
                    pad = []
                    for s, t in zip(reversed(skipped.shape[2:]), reversed(x.shape[2:])):
                        pad += [0, s - t]
                    x = F.pad(x, pad)
                x = x + skipped
        return x


class UNet(nn.Module):
    """The residual UNet of one view (reference unet.py:222-308): ``{view: (batch, *spatial, in_chans)}`` ->
    ``{view: (batch, *spatial, out_chans)}`` logits in ``dtype``, the compute dtype of the activations
    (parameters stay float32)."""

    def __init__(self, n_dims: int, in_chans: int, out_chans: int, chans: Sequence[int], dropout: float = 0.0,
                 patch_size: KernelSize = 2, scale_factor: KernelSize = 2, n_blocks: int = 2, kernel_size: int = 3,
                 norm: str = "instance", dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if n_dims not in (2, 3):
            raise ValueError(f"Invalid n_dims, must be 2 or 3, got {n_dims}.")
        self.dtype = dtype
        kwargs = dict(patch_size=patch_size, scale_factor=scale_factor, norm=norm, kernel_size=kernel_size,
                      n_blocks=n_blocks, dropout=dropout)
        self.encoder = DownsampleEncoder(n_dims, in_chans, chans, **kwargs)
        self.decoder = UpsampleDecoder(n_dims, chans, **kwargs)
        self.out_conv = Conv(n_dims, chans[0], out_chans, 1)

    def forward(self, image_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if len(image_dict) != 1:
            raise ValueError(f"Only one view is supported, got {len(image_dict)} views.")
        view, image = next(iter(image_dict.items()))
        # channels-last in -> (batch, chans, *spatial) in channels_last memory format
        x = self.decoder(self.encoder(image.to(self.dtype).contiguous().movedim(-1, 1)))
        return {view: self.out_conv(x).movedim(1, -1)}
