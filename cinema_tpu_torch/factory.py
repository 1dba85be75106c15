"""Model factories from config + finetuned loading (port of cinema_tpu/factory.py,
the ConvUNetR and CineMA parts; reference cinema/segmentation/convunetr.py:164-210,
487-521 and cinema/mae/mae.py:231-282).

Weights are float32 parameters on ``device``; ``dtype`` is the compute
dtype of the activations (bfloat16 on the card).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.config import Config, load_config
from cinema_tpu_torch.convert import drop_frozen_pos_embeds, load_safetensors
from cinema_tpu_torch.models.convunetr import ConvUNetR
from cinema_tpu_torch.models.mae import CineMA
from cinema_tpu_torch.models.vit import get_vit_config
from cinema_tpu_torch.ops.pos_embed import get_nd_sincos_pos_embed


def _views(config: Config) -> list[str]:
    views = config.model.views
    return [views] if isinstance(views, str) else list(views)


def _view_data_config(config: Config, view: str) -> Config:
    if view == "sax":
        return config.data.sax
    if "lax" in config.data:
        return config.data.lax
    return config.data[view]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; asking for CUDA where there is none raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("A CUDA device was asked for but none is available; pass device='cpu' "
                           "to run on the CPU.")
    return device


def get_convunetr_model(
    config: Config, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> ConvUNetR:
    """Build ConvUNetR from a segmentation config, in eval mode on ``device``.

    Parameters hold torch's default initialisation; call :func:`init_weights`
    for the JAX package's seeded scheme or load a checkpoint.
    """
    device = resolve_device(device)
    views = _views(config)
    vit = get_vit_config(config.model.convunetr.size)
    ndim = {v: 3 if v == "sax" else 2 for v in views}
    m = config.model.convunetr
    model = ConvUNetR(
        image_size_dict={v: tuple(_view_data_config(config, v).patch_size) for v in views},
        in_chans_dict={v: _view_data_config(config, v).in_chans for v in views},
        out_chans=config.model.out_chans,
        enc_patch_size_dict={v: tuple(m.enc_patch_size[: ndim[v]]) for v in views},
        enc_scale_factor_dict={v: tuple(m.enc_scale_factor[: ndim[v]]) for v in views},
        enc_conv_chans=tuple(m.enc_conv_chans),
        enc_conv_n_blocks=m.enc_conv_n_blocks,
        enc_embed_dim=vit["enc_embed_dim"],
        enc_depth=vit["enc_depth"],
        enc_n_heads=vit["enc_n_heads"],
        dec_chans=tuple(m.dec_chans),
        dec_patch_size_dict={v: tuple(m.dec_patch_size[: ndim[v]]) for v in views},
        dec_scale_factor_dict={v: tuple(m.dec_scale_factor[: ndim[v]]) for v in views},
        dropout=m.get("dropout", 0.0),
        drop_path=m.get("drop_path", 0.0),
        dtype=dtype,
    )
    return model.to(device).eval()


def get_mae_model(
    config: Config,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    remat: Optional[bool] = None,
) -> CineMA:
    """Build CineMA from the pretrain config schema (reference mae.py:231-282), in train mode on ``device``.

    ``remat`` defaults to the config's ``grad_ckpt``. Parameters hold torch's
    default initialisation; call :func:`init_weights` for the JAX package's
    seeded scheme or load a checkpoint.
    """
    device = resolve_device(device)
    views = list(config.model.get("views", ["sax", "lax_2c", "lax_3c", "lax_4c"]))
    vit = get_vit_config(config.model.size)
    image_size_dict, in_chans_dict, patch_dict, scale_dict = {}, {}, {}, {}
    for v in views:
        data = config.data.sax if v == "sax" else config.data.lax
        nd = 3 if v == "sax" else 2
        image_size_dict[v] = tuple(data.patch_size)
        in_chans_dict[v] = data.in_chans
        patch_dict[v] = tuple(config.model.patch_size[:nd])
        scale_dict[v] = tuple(config.model.scale_factor[:nd])
    model = CineMA(
        image_size_dict=image_size_dict,
        in_chans_dict=in_chans_dict,
        enc_patch_size_dict=patch_dict,
        enc_scale_factor_dict=scale_dict,
        enc_conv_chans=tuple(config.model.enc_conv_chans),
        enc_conv_n_blocks=config.model.enc_conv_n_blocks,
        remat=bool(config.get("grad_ckpt", False)) if remat is None else remat,
        dtype=dtype,
        **vit,
    )
    return model.to(device).train()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation with the JAX package's scheme (cinema_tpu/models/layers.py):
    Linear xavier-uniform + zero bias; Conv/ConvTranspose torch default
    U(+-1/sqrt(fan_in)); norms ones/zeros; cls and mask tokens N(0, 0.02).

    Drawn on the CPU from one ``torch.Generator``, so the weights depend on
    the seed only, not on the device.
    """
    gen = torch.Generator().manual_seed(seed)

    def uniform_(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)

    for module in model.modules():
        if isinstance(module, nn.Linear):
            fan_out, fan_in = module.weight.shape
            uniform_(module.weight, math.sqrt(6.0 / (fan_in + fan_out)))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.conv._ConvNd):
            # torch's fan_in: weight.shape[1] * prod(kernel) for Conv and ConvTranspose alike
            fan_in = module.weight.shape[1] * math.prod(module.weight.shape[2:])
            uniform_(module.weight, 1.0 / math.sqrt(fan_in))
            if module.bias is not None:
                uniform_(module.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("cls_token", "mask_token")):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def expected_frozen_pos_embeds(model: ConvUNetR) -> Dict[str, np.ndarray]:
    """The checkpoint's frozen ``enc_down_dict.{view}.pos_embed`` tables, recomputed."""
    return {
        f"enc_down_dict.{view}.pos_embed": get_nd_sincos_pos_embed(enc.embed_dim, enc.grid_size)[None]
        for view, enc in model.enc_down_dict.items()
    }


def from_finetuned(
    kind: str,
    model_path: Union[str, Path],
    config_path: Union[str, Path],
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> ConvUNetR:
    """Rebuild a finetuned ConvUNetR from local config.yaml + safetensors paths."""
    if kind != "convunetr":
        raise NotImplementedError(f"kind {kind!r} is not ported; only 'convunetr' is.")
    device = resolve_device(device)
    model = get_convunetr_model(load_config(config_path), dtype=dtype, device=device)
    state = drop_frozen_pos_embeds(load_safetensors(model_path), expected_frozen_pos_embeds(model))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model
