"""ResNet baselines for classification and regression, 2-D or 3-D by the input's rank (port of
cinema_tpu/models/resnet.py; reference cinema/resnet.py).

A dict of one channels-last image in, ``(batch, out_chans)`` out. The stem is a 7^nd convolution
of stride 2 padded by 3 on each side, BatchNorm, ReLU and a max-pool 3 of stride 2 padded by 1;
then per stage basic or bottleneck blocks (the first of every stage after the first of stride 2),
a global average pool and a linear head. Module names are the reference's (``layer1.0.conv1``,
``layer2.0.downsample_bn``), so a state_dict exported by the JAX package's bridge loads as it is.

:class:`BatchNorm` is flax's ``BatchNorm`` as the JAX package sets it, not ``nn.BatchNormNd``:
float32 statistics and output, and a running variance that follows the *biased* batch variance.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from cinema_tpu_torch.models.layers import Conv, Dense


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of (batch, chans, *spatial) with flax's semantics as the JAX package
    sets them (momentum 0.9, eps 1e-5, ``dtype=float32``).

    In train mode the output is normalised by the batch's mean and biased variance, and the running
    statistics become ``0.9 * running + 0.1 * batch``, the variance the biased ``E[x^2] - E[x]^2`` as
    flax takes it (torch's BatchNorm would use the unbiased n/(n-1) variance there). In eval mode the
    running statistics normalise. The output is float32 whatever the input's dtype; there is no
    ``num_batches_tracked``.
    """

    momentum = 0.9  # flax's: the weight of the running statistics

    def __init__(self, n_chans: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n_chans))
        self.bias = nn.Parameter(torch.zeros(n_chans))
        self.register_buffer("running_mean", torch.zeros(n_chans))
        self.register_buffer("running_var", torch.ones(n_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # flax's promotion: bf16 up, f64 kept
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            dims = [0, *range(2, x.ndim)]
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
            self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BasicBlock(nn.Module):
    """3^nd-3^nd residual block (reference resnet.py:49-106); a 1^nd conv and BatchNorm on the shortcut
    where the width or the stride changes. Convolutions compute in ``dtype``, BatchNorm in float32."""

    expansion = 1

    def __init__(self, nd: int, in_planes: int, planes: int, stride: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(nd, in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(nd, planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample_conv = self.downsample_bn = None
        if in_planes != planes or stride != 1:
            self.downsample_conv = Conv(nd, in_planes, planes, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        out = self.bn2(self.conv2(out.to(self.dtype)))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x.to(self.dtype)))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1^nd-3^nd-1^nd bottleneck block of expansion 4 (reference resnet.py:109-172)."""

    expansion = 4

    def __init__(self, nd: int, in_planes: int, planes: int, stride: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        out_planes = planes * self.expansion
        self.conv1 = Conv(nd, in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(nd, planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(nd, planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm(out_planes)
        self.downsample_conv = self.downsample_bn = None
        if in_planes != out_planes or stride != 1:
            self.downsample_conv = Conv(nd, in_planes, out_planes, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        out = F.relu(self.bn2(self.conv2(out.to(self.dtype))))
        out = self.bn3(self.conv3(out.to(self.dtype)))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x.to(self.dtype)))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet of ``nd`` spatial dims (2 or 3): ``layers`` blocks per stage of widths ``layer_inplanes``,
    basic blocks or, with ``bottleneck``, bottlenecks. ``dtype`` is the compute dtype of the
    convolutions and the head; parameters and running statistics stay float32."""

    def __init__(self, nd: int, in_chans: int, out_chans: int, layers: Sequence[int] = (2, 2, 2, 2),
                 layer_inplanes: Sequence[int] = (64, 128, 256, 512), bottleneck: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if nd not in (2, 3):
            raise ValueError(f"Invalid nd, must be 2 or 3, got {nd}.")
        self.nd, self.dtype, self.n_stages = nd, dtype, len(layers)
        self.conv1 = Conv(nd, in_chans, layer_inplanes[0], 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(layer_inplanes[0])
        block_cls = Bottleneck if bottleneck else BasicBlock
        in_planes = layer_inplanes[0]
        for stage, (n_blocks, planes) in enumerate(zip(layers, layer_inplanes)):
            blocks = []
            for b in range(n_blocks):
                blocks.append(block_cls(nd, in_planes, planes, 2 if (stage > 0 and b == 0) else 1, dtype))
                in_planes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
        self.fc = Dense(in_planes, out_chans)

    def forward(self, image_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
        if len(image_dict) != 1:
            raise ValueError(f"Only one view is supported, got {len(image_dict)} views.")
        # channels-last in -> (batch, chans, *spatial) in channels_last memory format
        x = next(iter(image_dict.values())).to(self.dtype).contiguous().movedim(-1, 1)
        x = F.relu(self.bn1(self.conv1(x)))
        x = (F.max_pool2d if self.nd == 2 else F.max_pool3d)(x, 3, stride=2, padding=1)
        for stage in range(self.n_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x)
        x = x.mean(dim=tuple(range(2, x.ndim)))  # global average pool
        return self.fc(x.to(self.dtype))


_PRESETS = {
    "resnet10": dict(layers=(1, 1, 1, 1), bottleneck=False),
    "resnet18": dict(layers=(2, 2, 2, 2), bottleneck=False),
    "resnet34": dict(layers=(3, 4, 6, 3), bottleneck=False),
    "resnet50": dict(layers=(3, 4, 6, 3), bottleneck=True),
}


def get_resnet(size: str, nd: int, in_chans: int, out_chans: int, dtype: torch.dtype = torch.float32) -> ResNet:
    """The reference's presets (get_resnet2d/3d, resnet.py:283-456): resnet10, 18, 34 and 50."""
    if size not in _PRESETS:
        raise ValueError(f"size must be in {sorted(_PRESETS)}, got {size}.")
    return ResNet(nd, in_chans, out_chans, dtype=dtype, **_PRESETS[size])
