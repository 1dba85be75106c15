"""CineMA: multi-view cine masked autoencoder (port of cinema_tpu/models/mae.py;
reference cinema/mae/mae.py).

Per-view conv stems -> shared ViT encoder over the concatenated visible
tokens -> multi-scale fusion -> shared cross-attention decoder (queries =
cls + mask tokens, keys = visible tokens) -> per-view linear pred heads.

Masks are :class:`PatchMask` index tensors, so every gather has a fixed
shape, and the mean over the views' finite losses is taken on the device:
a training step reads nothing back to the host. The public layout is
channels-last as in the JAX package, images (batch, *spatial, chans) in;
module names follow the reference checkpoint ``cinema.safetensors``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from cinema_tpu_torch.models.convvit import DownsampleEncoder, MultiScaleFusion
from cinema_tpu_torch.models.layers import Dense
from cinema_tpu_torch.models.vit import ViTDecoder, ViTEncoder, get_pos_embed_array
from cinema_tpu_torch.ops.masking import PatchMask, gather_tokens, random_patch_mask
from cinema_tpu_torch.ops.patch import patchify


def get_decoder_patch_size(
    image_size: Tuple[int, ...],
    n_conv_layers: int,
    enc_patch_size: Tuple[int, ...],
    enc_scale_factor: Tuple[int, ...],
) -> Tuple[int, ...]:
    """Effective decoder patch size (reference mae.py:207-228)."""
    dec = (1,) * len(image_size)
    for i in range(1 + n_conv_layers):
        p = enc_patch_size if i == 0 else enc_scale_factor
        dec = tuple(s * q for s, q in zip(dec, p))
    return dec


def mse_loss(
    target: torch.Tensor,
    pred: torch.Tensor,
    mask: PatchMask,
    norm_target: bool,
    epsilon: float = 1.0e-6,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE on the masked patches only (reference mae.py:107-152), in float32.

    Args:
        target: (batch, n_patches, out_chans) patchified image.
        pred: (batch, n_masked, out_chans) predictions.
        mask: PatchMask whose mask_ids select the target rows.
        norm_target: per-patch normalisation of the target (unbiased variance).
        epsilon: div-by-zero guard.

    Returns:
        scalar loss, metrics dict (device tensors).
    """
    target = target.detach().float()
    pred = pred.float()
    mean = target.mean(dim=-1, keepdim=True)
    std = target.var(dim=-1, keepdim=True, correction=1) ** 0.5
    metrics = {"target_mean": mean.mean(), "target_std": std.mean()}
    if norm_target:
        target = (target - mean) / (std + epsilon)
    target = gather_tokens(target, mask.mask_ids)
    loss = torch.mean(torch.square(pred - target))
    metrics["mse_loss"] = loss.detach()
    if norm_target and target.shape[1] > 0:
        metrics["normed_target_max"] = target.max()
        metrics["pred_max"] = pred.detach().max()
    return loss, metrics


class DecoderEmbedding(nn.Module):
    """Per-view decoder pos-embed gather + mask token (reference mae.py:155-204)."""

    def __init__(self, enc_grid_size: Tuple[int, ...], dec_embed_dim: int) -> None:
        super().__init__()
        self.enc_grid_size = tuple(enc_grid_size)
        self.dec_embed_dim = dec_embed_dim
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec_embed_dim))
        self._pos_embed: dict = {}

    def pos_embed(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (str(device), dtype)
        if key not in self._pos_embed:
            table = get_pos_embed_array(self.dec_embed_dim, self.enc_grid_size)[0]
            self._pos_embed[key] = torch.from_numpy(table).to(device=device, dtype=dtype)
        return self._pos_embed[key]

    def forward(self, x: torch.Tensor, mask: PatchMask) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (batch, n_keep, D) visible tokens (no cls).

        Returns:
            x_vis: (batch, n_keep, D) with the pos-embed added.
            x_mask: (batch, n_masked, D) mask tokens with the pos-embed added.
        """
        pos_embed = self.pos_embed(x.device, x.dtype)
        x_vis = x + gather_tokens(pos_embed, mask.keep_ids)
        x_mask = self.mask_token.to(x.dtype) + gather_tokens(pos_embed, mask.mask_ids)
        return x_vis, x_mask


class CineMA(nn.Module):
    """Cine masked autoencoder (reference mae.py:285-612)."""

    def __init__(
        self,
        image_size_dict: Dict[str, Tuple[int, ...]],
        in_chans_dict: Dict[str, int],
        enc_patch_size_dict: Dict[str, Tuple[int, ...]],
        enc_scale_factor_dict: Dict[str, Tuple[int, ...]],
        enc_conv_chans: Tuple[int, ...],
        enc_conv_n_blocks: int,
        enc_embed_dim: int,
        enc_depth: int,
        enc_n_heads: int,
        dec_embed_dim: int,
        dec_depth: int,
        dec_n_heads: int,
        mlp_ratio: float = 4,
        qkv_bias: bool = True,
        norm_target: bool = False,
        cross_attn: bool = True,
        norm_eps: float = 1e-5,
        drop_path: float = 0.0,
        norm: str = "layer",
        remat: bool = False,
        sparse_masking: bool = True,
        rotary: bool = False,
        mlp_type: str = "mlp",
        dtype: torch.dtype = torch.float32,
    ) -> None:
        """``sparse_masking`` runs the stems on the visible cells only during
        masked training (exact for per-position norms, see ops/sparse_cells.py);
        ``dtype`` is the compute dtype of the activations, parameters stay float32."""
        super().__init__()
        self.views = list(image_size_dict)
        self.image_size_dict = {v: tuple(s) for v, s in image_size_dict.items()}
        self.in_chans_dict = dict(in_chans_dict)
        self.norm_target = norm_target
        self.cross_attn = cross_attn
        self.dtype = dtype
        self.dec_patch_size_dict = {
            v: get_decoder_patch_size(
                self.image_size_dict[v], len(enc_conv_chans), tuple(enc_patch_size_dict[v]),
                tuple(enc_scale_factor_dict[v]),
            )
            for v in self.views
        }
        self.enc_down_dict = nn.ModuleDict(
            {
                v: DownsampleEncoder(
                    image_size_dict[v], in_chans_dict[v], enc_patch_size_dict[v], enc_scale_factor_dict[v],
                    enc_conv_chans, enc_conv_n_blocks, enc_embed_dim, norm, sparse_masking=sparse_masking,
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
        self.dec_linear = Dense(enc_embed_dim, dec_embed_dim)
        self.dec_embed_dict = nn.ModuleDict(
            {v: DecoderEmbedding(self.enc_down_dict[v].grid_size, dec_embed_dim) for v in self.views}
        )
        self.decoder = ViTDecoder(
            dec_embed_dim, dec_depth, dec_n_heads, mlp_ratio, qkv_bias, norm_eps, drop_path, remat=remat,
            rotary=rotary, mlp_type=mlp_type,
        )
        self.pred_head_dict = nn.ModuleDict(
            {
                v: Dense(dec_embed_dim, math.prod(self.dec_patch_size_dict[v]) * in_chans_dict[v])
                for v in self.views
            }
        )

    def _check_views(self, image_dict: Dict[str, torch.Tensor]) -> List[str]:
        views = list(image_dict)
        for v in views:
            if v not in self.views:
                raise ValueError(f"views {views} must be in {self.views}.")
        return views

    def _stem_input(self, image: torch.Tensor) -> torch.Tensor:
        """Channels-last image -> (batch, chans, *spatial) in the compute dtype."""
        return image.to(self.dtype).movedim(-1, 1)

    def feature_forward(self, image_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Feature extraction without a mask (reference mae.py:457-502).

        Returns {'cls': (batch, 1, E), view: (batch, n_patches_view, E)}.
        """
        views = self._check_views(image_dict)
        xs, ns_keep, skips_view = [], [], []
        for view in views:
            skip_view, x_view = self.enc_down_dict[view](self._stem_input(image_dict[view]), None)
            skips_view.append(skip_view)
            ns_keep.append(x_view.shape[1])
            xs.append(x_view)
        x = self.encoder(torch.cat(xs, dim=1))
        xs = list(torch.split(x, [1, *ns_keep], dim=1))
        for i, view in enumerate(views):
            xs[i + 1] = self.enc_fusion_dict[view](skips_view[i], xs[i + 1], None)
        return dict(zip(["cls", *views], xs))

    def draw_masks(
        self, image_dict: Dict[str, torch.Tensor], enc_mask_ratio: float, generator: Optional[torch.Generator],
        batch: Optional[int] = None,
    ) -> Dict[str, PatchMask]:
        """The masks that :meth:`forward` draws for ``image_dict`` when given none: one view after
        another from ``generator``, for ``batch`` rows (default: the images')."""
        views = self._check_views(image_dict)
        first = image_dict[views[0]]
        rows = first.shape[0] if batch is None else batch
        return {view: random_patch_mask(generator, rows, self.enc_down_dict[view].n_patches, enc_mask_ratio,
                                        first.device) for view in views}

    def forward(
        self,
        image_dict: Dict[str, torch.Tensor],
        enc_mask_ratio: float,
        mask_dict: Optional[Dict[str, PatchMask]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, PatchMask], Dict[str, torch.Tensor]]:
        """MAE training forward (reference mae.py:504-612).

        Args:
            image_dict: per-view images (batch, *spatial, in_chans).
            enc_mask_ratio: mask ratio.
            mask_dict: masks drawn by the caller; drawn here from
                ``generator`` otherwise, one view after another.
            generator: source of the mask noise (torch's global one if None).

        Returns:
            loss: mean over the views with finite losses (NaN if none), on the device.
            pred_dict: per-view (batch, n_masked_view, out_chans).
            mask_dict: per-view PatchMask.
            metrics: scalar device tensors.
        """
        views = self._check_views(image_dict)
        if mask_dict is None:
            mask_dict = self.draw_masks(image_dict, enc_mask_ratio, generator)

        # conv stems with masked conv blocks, gathered to the visible tokens
        xs, ns_keep, ns_masked, skips_view = [], [], [], []
        for view in views:
            mask = mask_dict[view]
            skip_view, x_view = self.enc_down_dict[view](self._stem_input(image_dict[view]), mask)
            if x_view.shape[1] != mask.n_keep:
                # the dense stem returns full-grid tokens; the sparse one has gathered already
                x_view = gather_tokens(x_view, mask.keep_ids)
            skips_view.append(skip_view)
            ns_keep.append(x_view.shape[1])
            ns_masked.append(mask.n_masked)
            xs.append(x_view)

        # shared encoder over all views' visible tokens (+ cls), then the skips
        x = self.encoder(torch.cat(xs, dim=1))
        xs = list(torch.split(x, [1, *ns_keep], dim=1))
        for i, view in enumerate(views):
            xs[i + 1] = self.enc_fusion_dict[view](skips_view[i], xs[i + 1], mask_dict[view])

        x = self.dec_linear(torch.cat(xs, dim=1))
        xs = list(torch.split(x, [1, *ns_keep], dim=1))
        xs_vis, xs_mask = [], []
        for i, view in enumerate(views):
            x_vis_view, x_mask_view = self.dec_embed_dict[view](xs[i + 1], mask_dict[view])
            xs_vis.append(x_vis_view)
            xs_mask.append(x_mask_view)

        if self.cross_attn:
            x = self.decoder(torch.cat([xs[0], *xs_mask], dim=1), torch.cat(xs_vis, dim=1), sum(ns_masked))
        else:
            x = self.decoder(torch.cat([xs[0], *xs_vis, *xs_mask], dim=1), None, sum(ns_masked))
        xs = torch.split(x, ns_masked, dim=1)

        # per-view heads and masked MSE; the mean is over the finite view losses
        preds, view_losses = {}, []
        metrics: Dict[str, torch.Tensor] = {}
        for i, view in enumerate(views):
            preds[view] = self.pred_head_dict[view](xs[i])
            target = patchify(image_dict[view], self.dec_patch_size_dict[view])
            loss_view, metrics_view = mse_loss(target, preds[view], mask_dict[view], self.norm_target)
            metrics.update({f"{view}_{m}": v for m, v in metrics_view.items()})
            view_losses.append(loss_view)

        losses = torch.stack(view_losses)
        finite = torch.isfinite(losses)
        n_finite = finite.sum()
        mean = torch.where(finite, losses, torch.zeros_like(losses)).sum() / n_finite.clamp(min=1)
        loss = torch.where(n_finite > 0, mean, torch.full_like(mean, float("nan")))
        metrics["loss"] = loss.detach()
        return loss, preds, mask_dict, metrics
