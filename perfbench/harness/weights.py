"""Seeded weights made on the device, in a few large draws, keyed by the published parameter names.

The scheme is the published one (xavier-uniform linear weights and zero biases, convolutions
U(+-1/sqrt(fan_in)), norms ones and zeros, cls and mask tokens N(0, 0.02)); the values come from
one uniform and one normal draw of a generator seeded with ``seed`` on ``device``, cut into the
parameters in the order of the reference model. The same seed gives the same weights on one device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from perfbench.reference import models as ref


def _scheme(model: nn.Module) -> List[Tuple[str, torch.Size, str, float]]:
    """(name, shape, kind, scale) per parameter, kind one of uniform, normal, ones, zeros."""
    out = []
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for p_name, p in module.named_parameters(recurse=False):
            name = prefix + p_name
            if isinstance(module, nn.LayerNorm):
                out.append((name, p.shape, "ones" if p_name == "weight" else "zeros", 0.0))
            elif isinstance(module, nn.Linear):
                if p_name == "weight":
                    out.append((name, p.shape, "uniform", math.sqrt(6.0 / (p.shape[0] + p.shape[1]))))
                else:
                    out.append((name, p.shape, "zeros", 0.0))
            elif isinstance(module, (ref.ConvNd, ref.ConvTransposeNd)):
                fan_in = module.weight.shape[1] * math.prod(module.weight.shape[2:])
                out.append((name, p.shape, "uniform", 1.0 / math.sqrt(fan_in)))
            elif p_name in ("cls_token", "mask_token"):
                out.append((name, p.shape, "normal", 0.02))
            else:
                raise ValueError(f"No initialisation for the parameter {name}.")
    return out


def on_meta(step: str, cfg: dict) -> nn.Module:
    """The reference model of ``step`` on the meta device: shapes and names, no memory."""
    with torch.device("meta"):
        model = ref.MODELS[step](cfg)
    return model.to("meta")


def make_weights(model: nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 weights for every parameter of the reference ``model`` (which may live on ``meta``)."""
    scheme = _scheme(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    n_uniform = sum(math.prod(s) for _, s, kind, _ in scheme if kind == "uniform")
    n_normal = sum(math.prod(s) for _, s, kind, _ in scheme if kind == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2.0).sub_(1.0)
    normal = torch.randn(n_normal, generator=gen, device=device)
    weights, at = {}, {"uniform": 0, "normal": 0}
    for name, shape, kind, scale in scheme:
        n = math.prod(shape)
        if kind in at:
            source = uniform if kind == "uniform" else normal
            weights[name] = source[at[kind]:at[kind] + n].view(shape).mul(scale)
            at[kind] += n
        else:
            weights[name] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device)
    return weights
