"""Model factories from config + finetuned loading (port of cinema_tpu/factory.py: ConvUNetR,
the UNet baseline, CineMA and ConvViT; reference cinema/segmentation/convunetr.py:164-210,
487-521, segmentation/train.py:31-74, cinema/mae/mae.py:231-282 and cinema/convvit.py:294-332,
558-592).

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
from cinema_tpu_torch.models.convvit import ConvViT
from cinema_tpu_torch.models.mae import CineMA
from cinema_tpu_torch.models.unet import UNet
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
    config: Config,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    remat: Optional[bool] = None,
    **model_kwargs,
) -> ConvUNetR:
    """Build ConvUNetR from a segmentation config, in eval mode on ``device``; ``remat`` (the
    ViT blocks recomputed in the backward pass) defaults to the config's ``grad_ckpt``.
    ``model_kwargs`` go to the constructor for what no config key sets (``rotary``, ``mlp_type``).

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
        remat=bool(config.get("grad_ckpt", False)) if remat is None else remat,
        dtype=dtype,
        **model_kwargs,
    )
    return model.to(device).eval()


def get_unet_model(
    config: Config, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> UNet:
    """Build the UNet baseline of one view from a segmentation config's ``model.unet`` section (reference
    segmentation/train.py:55-69), in eval mode on ``device``; 3-D where the view's ``spacing`` has three
    entries. Instance norm, as the JAX package builds it."""
    device = resolve_device(device)
    views = _views(config)
    if len(views) > 1:
        raise ValueError("UNet only supports single view.")
    data = _view_data_config(config, views[0])
    ndim = 3 if views[0] == "sax" else 2
    m = config.model.unet
    model = UNet(
        n_dims=len(data.spacing),
        in_chans=data.in_chans,
        out_chans=config.model.out_chans,
        patch_size=tuple(m.patch_size[:ndim]),
        chans=tuple(m.chans),
        scale_factor=tuple(m.scale_factor[:ndim]),
        dropout=m.get("dropout", 0.0),
        dtype=dtype,
    )
    return model.to(device).eval()


def get_segmentation_model(
    config: Config, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda"
) -> nn.Module:
    """The model ``config.model.name`` names (reference segmentation/train.py:31-74): ConvUNetR or UNet."""
    if config.model.name == "convunetr":
        return get_convunetr_model(config, dtype=dtype, device=device)
    if config.model.name == "unet":
        return get_unet_model(config, dtype=dtype, device=device)
    raise ValueError(f"Invalid model name {config.model.name}.")


def get_convvit_model(
    config: Config,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    remat: Optional[bool] = None,
    **model_kwargs,
) -> ConvViT:
    """Build ConvViT from a classification or regression config (reference convvit.py:294-332),
    in eval mode on ``device``; ``remat`` defaults to the config's ``grad_ckpt``.
    ``model_kwargs`` go to the constructor for what no config key sets (``rotary``,
    ``mlp_type``), as ``.clone(rotary=True)`` does on the JAX package's module.

    The width of the head follows the data section: one logit per class of
    ``data.class_column``, one output for ``data.regression_column``, else
    ``model.out_chans``.
    """
    device = resolve_device(device)
    views = _views(config)
    vit = get_vit_config(config.model.convvit.size)
    if "class_column" in config.data:
        out_chans = len(config.data[config.data.class_column])
    elif "regression_column" in config.data:
        out_chans = 1
    else:
        out_chans = config.model.out_chans
    ndim = {v: 3 if v == "sax" else 2 for v in views}
    m = config.model.convvit
    model = ConvViT(
        image_size_dict={v: tuple(_view_data_config(config, v).patch_size) for v in views},
        in_chans_dict={v: _view_data_config(config, v).in_chans for v in views},
        n_frames=config.model.n_frames,
        out_chans=out_chans,
        enc_patch_size_dict={v: tuple(m.enc_patch_size[: ndim[v]]) for v in views},
        enc_scale_factor_dict={v: tuple(m.enc_scale_factor[: ndim[v]]) for v in views},
        enc_conv_chans=tuple(m.enc_conv_chans),
        enc_conv_n_blocks=m.enc_conv_n_blocks,
        enc_embed_dim=vit["enc_embed_dim"],
        enc_depth=vit["enc_depth"],
        enc_n_heads=vit["enc_n_heads"],
        drop_path=m.get("drop_path", 0.0),
        remat=bool(config.get("grad_ckpt", False)) if remat is None else remat,
        dtype=dtype,
        **model_kwargs,
    )
    return model.to(device).eval()


def get_mae_model(
    config: Config,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    remat: Optional[bool] = None,
    **model_kwargs,
) -> CineMA:
    """Build CineMA from the pretrain config schema (reference mae.py:231-282), in train mode on ``device``.
    ``model_kwargs`` go to the constructor for what no config key sets (``rotary``, ``mlp_type``).

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
        **model_kwargs,
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


def expected_frozen_pos_embeds(model: nn.Module) -> Dict[str, np.ndarray]:
    """The checkpoint's frozen ``enc_down_dict.{view}.pos_embed`` tables, recomputed; none for a model
    without a ViT encoder (the UNet and ResNet baselines)."""
    return {
        f"enc_down_dict.{view}.pos_embed": get_nd_sincos_pos_embed(enc.embed_dim, enc.grid_size)[None]
        for view, enc in getattr(model, "enc_down_dict", {}).items()
    }


def _load_strict(model: nn.Module, model_path: Union[str, Path]) -> None:
    """Load a safetensors checkpoint into ``model`` strictly, its frozen pos-embed tables checked and dropped."""
    state = drop_frozen_pos_embeds(load_safetensors(model_path), expected_frozen_pos_embeds(model))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)


def mae_from_pretrained(
    model_path: Union[str, Path],
    config_path: Union[str, Path],
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> CineMA:
    """Rebuild a pretrained CineMA from local config.yaml + safetensors paths, in eval mode (the JAX package's
    ``mae_from_pretrained``, cinema_tpu/factory.py:236-262, whose HuggingFace download is not ported)."""
    model = get_mae_model(load_config(config_path), dtype=dtype, device=device, remat=False)
    _load_strict(model, model_path)
    return model.eval()


def from_finetuned(
    kind: str,
    model_path: Union[str, Path],
    config_path: Union[str, Path],
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> Union[ConvUNetR, ConvViT]:
    """Rebuild a finetuned ConvUNetR or ConvViT (``kind`` 'convunetr' or 'convvit') from
    local config.yaml + safetensors paths, in eval mode."""
    if kind not in ("convunetr", "convvit"):
        raise ValueError(f"kind must be 'convunetr' or 'convvit', got {kind}.")
    device = resolve_device(device)
    if kind == "convunetr":
        model = get_convunetr_model(load_config(config_path), dtype=dtype, device=device, remat=False)
    else:
        model = get_convvit_model(load_config(config_path), dtype=dtype, device=device, remat=False)
    _load_strict(model, model_path)
    return model
