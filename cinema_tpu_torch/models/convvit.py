"""ConvMAE conv stems and skip fusion around the ViT (port of
cinema_tpu/models/convvit.py; reference cinema/convvit.py:54-291).

The frozen sincos pos-embed is recomputed (numpy) and added as a constant,
not stored as a parameter. Masks are :class:`PatchMask` index tensors. With a
mask the stem runs either densely with mask multiplies, as the reference
does, or on the visible cells only (``sparse_masking``), which gives the
same values at visible positions for a quarter of the work at ratio 0.75.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from cinema_tpu_torch.models.layers import Conv, ConvNormActBlock, Dense, LayerNorm, MaskedConvBlock
from cinema_tpu_torch.models.vit import PatchEmbed, ViTEncoder
from cinema_tpu_torch.ops.masking import PatchMask, gather_tokens, upsample_mask
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
                 embed_dim: int, norm: str = "layer", sparse_masking: bool = False) -> None:
        super().__init__()
        nd = len(image_size)
        self.embed_dim = embed_dim
        self.norm = norm
        self.sparse_masking = sparse_masking
        self.patch_sizes = [tuple(patch_size)] + [tuple(scale_factor)] * len(conv_chans)
        conv_sizes, self.eff_patch_size, self.grid_size = downsample_stack_sizes(
            image_size, patch_size, scale_factor, len(conv_chans)
        )
        self.n_patches = math.prod(self.grid_size)
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

    def forward(self, image: torch.Tensor, mask: Optional[PatchMask] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """image: (batch, in_chans, *spatial); mask at the ViT grid size.

        Returns:
            skips: per-conv-level features (batch, chans_i, *size_i); on the
                sparse path the visible cells (batch, k, chans_i, *cell_i).
            x: (batch, n_patches, embed_dim) tokens with the pos-embed added;
                on the sparse path already gathered to (batch, k, embed_dim).
        """
        grid_size = tuple(s // p for s, p in zip(image.shape[2:], self.eff_patch_size))
        # the sparse path is exact only without stem drop-path: in the cell
        # layout DropPath would draw per visible cell, not per sample
        sparse_exact = all(
            c.drop_path1.rate == 0.0 and c.drop_path2.rate == 0.0 for b in self.conv_blocks for c in b.conv
        )
        if mask is not None and self.sparse_masking and self.norm == "layer" and sparse_exact:
            return self._sparse_forward(image, grid_size, mask)

        conv_masks: List[Optional[torch.Tensor]] = [None] * len(self.conv_blocks)
        if mask is not None:
            # visible masks at each conv level's resolution, upsampled step
            # by step from the ViT grid (reference convvit.py:183-192)
            conv_masks = []
            vis = (~mask.bool_mask).reshape(mask.bool_mask.shape[0], *grid_size)
            for patch_size in self.patch_sizes[:0:-1]:
                vis = upsample_mask(vis, patch_size)
                conv_masks.insert(0, vis)

        skips = []
        x = image
        for block, conv_mask in zip(self.conv_blocks, conv_masks):
            x = block.patch_embed(x)
            for conv in block.conv:
                x = conv(x, conv_mask)
            skips.append(x)
        x = self.linear(self.patch_embed(x))
        return skips, x + self.pos_embed(grid_size, x.device, x.dtype)

    def _sparse_forward(self, image: torch.Tensor, grid_size: Tuple[int, ...],
                        mask: PatchMask) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The stem on the visible cells only. Every conv but the depthwise
        one has kernel == stride aligned to cell boundaries, so cells are
        independent; MaskedConvBlock densifies around its depthwise conv,
        where the scatter's zeros stand for the reference's mask multiply
        (reference conv.py:385-390)."""
        from cinema_tpu_torch.ops.sparse_cells import CellDenseCtx, gather_cells, image_to_cells

        vis = gather_cells(image_to_cells(image.movedim(1, -1), grid_size), mask.keep_ids)
        batch, n_keep = vis.shape[:2]
        x = vis.flatten(0, 1).movedim(-1, 1)  # (batch * k, chans, *cell)
        ctx = CellDenseCtx(grid_size=grid_size, keep_ids=mask.keep_ids)

        skips = []
        for block in self.conv_blocks:
            x = block.patch_embed(x)
            for conv in block.conv:
                x = conv(x, None, dense_ctx=ctx)
            skips.append(x.unflatten(0, (batch, n_keep)))
        x = self.linear(self.patch_embed(x))  # (batch * k, 1, E)
        x = x.reshape(batch, n_keep, self.embed_dim)
        pos = self.pos_embed(grid_size, x.device, x.dtype)[0]  # (n_cells, E)
        return skips, x + pos[mask.keep_ids]


class MultiScaleFusion(nn.Module):
    """Fuse the conv-stem skips into the ViT's output tokens (reference convvit.py:210-291)."""

    def __init__(self, image_size: Sequence[int], patch_size: Sequence[int], scale_factor: Sequence[int],
                 conv_chans: Sequence[int], embed_dim: int, norm_eps: float = 1e-5) -> None:
        super().__init__()
        self.nd = len(image_size)
        self.embed_dim = embed_dim
        conv_sizes, _, vit_grid = downsample_stack_sizes(image_size, patch_size, scale_factor, len(conv_chans))
        convs = []
        for size, chans in zip(conv_sizes, conv_chans):
            down_kernel = tuple(s // g for s, g in zip(size, vit_grid))
            convs.append(Conv(self.nd, chans, embed_dim, down_kernel, stride=down_kernel))
        self.down_convs = nn.ModuleList(convs)
        self.norm = LayerNorm(embed_dim, eps=norm_eps)

    def forward(self, skips: List[torch.Tensor], x: torch.Tensor, mask: Optional[PatchMask] = None) -> torch.Tensor:
        """skips: conv features, dense (batch, C_i, *size_i) or the visible
        cells (batch, k, C_i, *cell_i); x: (batch, n_keep, E) ViT tokens (no cls)."""
        for skip, conv in zip(skips, self.down_convs):
            if skip.ndim == self.nd + 3:
                # visible cells: the down conv (kernel == stride == cell size)
                # maps each cell to exactly one token, so nothing is gathered
                batch, n_keep = skip.shape[:2]
                down = conv(skip.flatten(0, 1)).reshape(batch, n_keep, self.embed_dim)
            else:
                down = conv(skip).flatten(2).transpose(1, 2)
                if mask is not None:
                    down = gather_tokens(down, mask.keep_ids)
            x = x + down
        return self.norm(x)


class ConvViT(nn.Module):
    """Multi-view ConvViT for classification and regression (reference convvit.py:335-613).

    ``n_frames`` frames are stacked as channels (ED + ES = 2), so a view's
    input is (batch, *image_size, n_frames * in_chans). ``dtype`` is the
    compute dtype of the activations, parameters stay float32.
    """

    def __init__(
        self,
        image_size_dict: Dict[str, Tuple[int, ...]],
        in_chans_dict: Dict[str, int],
        n_frames: int,
        out_chans: int,
        enc_patch_size_dict: Dict[str, Tuple[int, ...]],
        enc_scale_factor_dict: Dict[str, Tuple[int, ...]],
        enc_conv_chans: Tuple[int, ...],
        enc_conv_n_blocks: int,
        enc_embed_dim: int,
        enc_depth: int,
        enc_n_heads: int,
        mlp_ratio: float = 4,
        qkv_bias: bool = True,
        norm_eps: float = 1e-5,
        rotary: bool = False,
        drop_path: float = 0.0,
        norm: str = "layer",
        mlp_type: str = "mlp",
        remat: bool = False,
        use_head: bool = True,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.views = list(image_size_dict)
        self.image_size_dict = {v: tuple(s) for v, s in image_size_dict.items()}
        self.in_chans_dict = dict(in_chans_dict)
        self.n_frames = n_frames
        self.enc_embed_dim = enc_embed_dim
        self.enc_depth = enc_depth
        self.dtype = dtype
        self.enc_down_dict = nn.ModuleDict(
            {
                v: DownsampleEncoder(
                    image_size_dict[v], n_frames * in_chans_dict[v], enc_patch_size_dict[v],
                    enc_scale_factor_dict[v], enc_conv_chans, enc_conv_n_blocks, enc_embed_dim, norm,
                )
                for v in self.views
            }
        )
        self.enc_fusion_dict = nn.ModuleDict(
            {
                v: MultiScaleFusion(
                    image_size_dict[v], enc_patch_size_dict[v], enc_scale_factor_dict[v], enc_conv_chans,
                    enc_embed_dim, norm_eps,
                )
                for v in self.views
            }
        )
        self.encoder = ViTEncoder(
            enc_embed_dim, enc_depth, enc_n_heads, mlp_ratio, qkv_bias, norm_eps, drop_path, remat=remat,
            rotary=rotary, mlp_type=mlp_type,
        )
        if use_head:
            self.pred_head_dict = nn.ModuleDict({v: Dense(enc_embed_dim, out_chans) for v in [*self.views, "cls"]})

    def feature_forward(
        self, image_dict: Dict[str, torch.Tensor], mask_dict: Optional[Dict[str, PatchMask]] = None
    ) -> Dict[str, torch.Tensor]:
        """Per-view stems -> shared encoder -> per-view fusion.

        Returns 'cls' (batch, 1, E) and per view (batch, n_patches, E). A mask
        zeroes the masked patches inside the dense stem only; the encoder and
        the fusion (its own mask is None, reference convvit.py:459-503) still
        see every token, so the output keeps its full size.
        """
        views = list(image_dict)
        for v in views:
            if v not in self.views:
                raise ValueError(f"views {views} must be in {self.views}.")
        xs, ns_patch, skips_view = [], [], {}
        for view in views:
            image = image_dict[view].to(self.dtype).contiguous().movedim(-1, 1)
            mask_view = mask_dict[view] if mask_dict is not None else None
            skips_view[view], x_view = self.enc_down_dict[view](image, mask_view)
            ns_patch.append(x_view.shape[1])
            xs.append(x_view)
        x = self.encoder(torch.cat(xs, dim=1))
        bounds = np_cumsum([1, *ns_patch])
        xs = [x[:, s:e] for s, e in zip([0, *bounds[:-1]], bounds)]
        x_dict = dict(zip(["cls", *views], xs))
        for view in views:
            x_dict[view] = self.enc_fusion_dict[view](skips_view[view], x_dict[view], None)
        return x_dict

    def forward(
        self,
        image_dict: Dict[str, torch.Tensor],
        mask_dict: Optional[Dict[str, PatchMask]] = None,
        reduce: str = "all",
    ) -> torch.Tensor:
        """Logits (batch, out_chans); ``reduce`` in {'patch', 'all', 'cls'}."""
        x_dict = self.feature_forward(image_dict, mask_dict)
        views = [v for v in x_dict if v != "cls"]
        if reduce in ("patch", "all"):
            logits = [self.pred_head_dict[v](x_dict[v].mean(dim=1, keepdim=True)) for v in views]
            if reduce == "all":
                logits.append(self.pred_head_dict["cls"](x_dict["cls"]))
            return torch.cat(logits, dim=1).mean(dim=1)
        if reduce == "cls":
            return self.pred_head_dict["cls"](x_dict["cls"])[:, 0]
        raise NotImplementedError(f"Unsupported reduce method {reduce}.")


def get_layer_id_for_vit(key: str, n_layers: int) -> int:
    """BEiT-style layer id for layer-wise LR decay (reference convvit.py:707-737).

    Args:
        key: a parameter's state_dict key.
        n_layers: encoder depth + 1.

    Returns:
        0 for conv stems and embeddings, i + 1 for encoder block i, n_layers for the rest.
    """
    if key.startswith("enc_"):
        return 0
    if any(x in key for x in ("cls_token", "pos_embed", "patch_embed", "view_embed")):
        return 0
    if key.startswith("encoder.blocks."):
        return int(key.split(".")[2]) + 1
    return n_layers
