"""ConvUNetR segmentation model (port of cinema_tpu/models/convunetr.py;
reference cinema/segmentation/convunetr.py).

Per-view ConvMAE DownsampleEncoder, shared ViT encoder, per-view decoder:
tokens reshaped to the grid -> extra strided-conv downsample levels ->
per-skip ConvResBlock adapters -> transpose-conv UpsampleDecoder with
additive skips -> 1x1 pred head.

The public layout is channels-last as in the JAX package: images
(batch, *spatial, chans) in, logits (batch, *spatial, classes) out. The
input is permuted once at entry; the permuted view is (batch, chans,
*spatial) in PyTorch's channels_last memory format, which cuDNN's
convolutions keep, so the exit permute is free as well. Module names follow
the reference checkpoints, so reference safetensors load without renaming.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from cinema_tpu_torch.models.convvit import DownsampleEncoder, np_cumsum
from cinema_tpu_torch.models.layers import Conv, ConvResBlock, ConvTranspose
from cinema_tpu_torch.models.vit import ViTEncoder


def check_conv_unetr_enc_dec_compatibility(
    enc_patch_size: Tuple[int, ...],
    enc_scale_factor: Tuple[int, ...],
    enc_n_conv_layers: int,
    dec_depth: int,
    dec_patch_size: Tuple[int, ...],
    dec_scale_factor: Tuple[int, ...],
) -> Tuple[int, int]:
    """Validate encoder/decoder geometry (reference convunetr.py:109-161).

    Returns:
        n_layers_wo_skip: decoder layers below the first conv-skip resolution.
        n_downsample_layers: extra strided-conv levels below the ViT grid.
    """
    if enc_n_conv_layers >= dec_depth:
        raise ValueError(f"enc_n_conv_layers {enc_n_conv_layers} must be less than dec_depth {dec_depth}.")
    if any(f < s for f, s in zip(enc_patch_size, dec_patch_size)):
        raise ValueError(f"enc_patch_size {enc_patch_size} must be greater than dec_patch_size {dec_patch_size}.")
    enc_patch_size = tuple(enc_patch_size)
    enc_factor = enc_patch_size
    for _ in range(enc_n_conv_layers):
        enc_factor = tuple(f * s for f, s in zip(enc_factor, enc_scale_factor))

    dec_factor = tuple(dec_patch_size)
    n_layers_wo_skip = None
    n_downsample_layers = None
    for i in range(dec_depth):
        if dec_factor == enc_patch_size:
            n_layers_wo_skip = i
        if dec_factor == enc_factor:
            n_downsample_layers = dec_depth - 1 - i
        dec_factor = tuple(f * s for f, s in zip(dec_factor, dec_scale_factor))

    if n_layers_wo_skip is None:
        raise ValueError(
            f"enc_patch_size {enc_patch_size} must be equal to "
            f"dec_patch_size {tuple(dec_patch_size)} times certain number of {tuple(dec_scale_factor)}."
        )
    if n_downsample_layers is None:
        raise ValueError(
            f"enc_factor {enc_factor} must be equal to "
            f"dec_patch_size {tuple(dec_patch_size)} times certain number of {tuple(dec_scale_factor)}."
        )
    return n_layers_wo_skip, n_downsample_layers


class UpsampleDecoder(nn.Module):
    """Transpose-conv up + residual blocks with additive skips (reference convunetr.py:25-106)."""

    def __init__(self, nd: int, chans: Sequence[int], patch_size: Sequence[int],
                 scale_factor: Sequence[int], kernel_size: int = 3, n_blocks: int = 2,
                 dropout: float = 0.0, norm: str = "layer") -> None:
        super().__init__()
        chans = tuple(chans)
        blocks = []
        for i, ch in enumerate(chans[::-1]):
            up_kernel = patch_size if i == len(chans) - 1 else scale_factor
            out_chans = chans[-i - 2] if i < len(chans) - 1 else ch
            block = nn.Module()
            block.up = ConvTranspose(nd, ch, out_chans, up_kernel)
            block.conv = nn.ModuleList(
                ConvResBlock(nd, out_chans, out_chans, kernel_size, dropout, norm) for _ in range(n_blocks)
            )
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, embeddings: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """embeddings: coarsest last; None entries skip the additive skip."""
        embeddings = list(embeddings)
        x = embeddings.pop()
        for block in self.blocks:
            x = block.up(x)
            skip = embeddings.pop()
            if skip is not None:
                x = x + skip
            for conv in block.conv:
                x = conv(x)
        return x


class ConvUNetR(nn.Module):
    """Multi-view UNetR with ConvMAE encoder (reference convunetr.py:213-485)."""

    def __init__(
        self,
        image_size_dict: Dict[str, Tuple[int, ...]],
        in_chans_dict: Dict[str, int],
        out_chans: int,
        enc_patch_size_dict: Dict[str, Tuple[int, ...]],
        enc_scale_factor_dict: Dict[str, Tuple[int, ...]],
        enc_conv_chans: Tuple[int, ...],
        enc_conv_n_blocks: int,
        enc_embed_dim: int,
        enc_depth: int,
        enc_n_heads: int,
        dec_chans: Tuple[int, ...],
        dec_patch_size_dict: Dict[str, Tuple[int, ...]],
        dec_scale_factor_dict: Dict[str, Tuple[int, ...]],
        dec_kernel_size: int = 3,
        mlp_ratio: float = 4,
        qkv_bias: bool = True,
        norm_eps: float = 1e-5,
        dropout: float = 0.0,
        drop_path: float = 0.0,
        norm: str = "layer",
        rotary: bool = False,
        mlp_type: str = "mlp",
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.views = list(image_size_dict)
        self.image_size_dict = {v: tuple(s) for v, s in image_size_dict.items()}
        self.enc_embed_dim = enc_embed_dim
        self.dtype = dtype
        for view in self.views:
            if len(image_size_dict[view]) not in (2, 3):
                raise ValueError(f"Invalid image_size for {view}, must be 2D or 3D, got {image_size_dict[view]}.")
        geometry = {
            check_conv_unetr_enc_dec_compatibility(
                tuple(enc_patch_size_dict[v]), tuple(enc_scale_factor_dict[v]), len(enc_conv_chans),
                len(dec_chans), tuple(dec_patch_size_dict[v]), tuple(dec_scale_factor_dict[v]),
            )
            for v in self.views
        }
        if len(geometry) != 1:
            raise ValueError(f"Inconsistent enc/dec geometry across views: {geometry}.")
        self.n_layers_wo_skip, n_downsample_layers = geometry.pop()

        self.enc_down_dict = nn.ModuleDict(
            {
                v: DownsampleEncoder(
                    image_size_dict[v], in_chans_dict[v], enc_patch_size_dict[v], enc_scale_factor_dict[v],
                    enc_conv_chans, enc_conv_n_blocks, enc_embed_dim, norm,
                )
                for v in self.views
            }
        )
        self.enc_depth = enc_depth  # the layer decay's block count (train/optim.py layer_decay_scales)
        self.encoder = ViTEncoder(enc_embed_dim, enc_depth, enc_n_heads, mlp_ratio, qkv_bias, norm_eps, drop_path,
                                  remat=remat, rotary=rotary, mlp_type=mlp_type)

        self.dec_image_conv_block_dict = nn.ModuleDict()
        self.dec_down_blocks_dict = nn.ModuleDict()
        self.dec_conv_blocks_dict = nn.ModuleDict()
        self.decoder_dict = nn.ModuleDict()
        self.pred_head_dict = nn.ModuleDict()
        for v in self.views:
            nd = len(image_size_dict[v])
            self.dec_image_conv_block_dict[v] = ConvResBlock(
                nd, in_chans_dict[v], dec_chans[0], dec_kernel_size, dropout, norm
            )
            scale = tuple(dec_scale_factor_dict[v])
            self.dec_down_blocks_dict[v] = nn.ModuleList(
                Conv(nd, enc_embed_dim, enc_embed_dim, scale, stride=scale) for _ in range(n_downsample_layers)
            )
            skip_chans = list(enc_conv_chans) + [enc_embed_dim] * (n_downsample_layers + 1)
            self.dec_conv_blocks_dict[v] = nn.ModuleList(
                ConvResBlock(nd, ch, dec_chans[self.n_layers_wo_skip + i], dec_kernel_size, dropout, norm)
                for i, ch in enumerate(skip_chans)
            )
            self.decoder_dict[v] = UpsampleDecoder(
                nd, dec_chans, dec_patch_size_dict[v], scale, dec_kernel_size, dropout=dropout, norm=norm
            )
            self.pred_head_dict[v] = Conv(nd, dec_chans[0], out_chans, 1)

    def forward(self, image_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """image_dict: (batch, *image_size, in_chans) per view -> logits
        (batch, *image_size, out_chans) per view, in the model's dtype."""
        for v in image_dict:
            if v not in self.views:
                raise ValueError(f"views {list(image_dict)} must be in {self.views}.")
        # channels-last in -> (batch, chans, *spatial) views in channels_last memory format
        images = {v: x.to(self.dtype).contiguous().movedim(-1, 1) for v, x in image_dict.items()}

        xs, skips, ns = [], [], []
        for view, image in images.items():
            skips_view, x_view = self.enc_down_dict[view](image)
            skips.append(skips_view)
            xs.append(x_view)
            ns.append(x_view.shape[1])

        x = self.encoder(torch.cat(xs, dim=1))
        bounds = np_cumsum([1, *ns])
        xs = [x[:, s:e] for s, e in zip([0, *bounds[:-1]], bounds)][1:]  # drop cls

        logits = {}
        for i, (view, image) in enumerate(images.items()):
            grid = tuple(s // p for s, p in zip(image.shape[2:], self.enc_down_dict[view].eff_patch_size))
            # tokens are row-major over the grid: (b, n, e) -> (b, e, *grid)
            x_view = xs[i].reshape(xs[i].shape[0], *grid, self.enc_embed_dim).movedim(-1, 1)
            skips_view = [*skips[i], x_view]
            for block in self.dec_down_blocks_dict[view]:
                x_view = block(x_view)
                skips_view.append(x_view)

            embeddings: List[Optional[torch.Tensor]] = [self.dec_image_conv_block_dict[view](image)]
            embeddings += [None] * self.n_layers_wo_skip
            for j, block in enumerate(self.dec_conv_blocks_dict[view]):
                embeddings.append(block(skips_view[j]))
            out = self.pred_head_dict[view](self.decoder_dict[view](embeddings))
            logits[view] = out.movedim(1, -1)
        return logits

    def predict_labels(self, image_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Argmax labels (batch, *image_size) uint8 per view."""
        return {v: torch.argmax(x, dim=-1).to(torch.uint8) for v, x in self(image_dict).items()}
