"""Primitive layers (port of cinema_tpu/models/layers.py; reference cinema/conv.py).

Conventions of the port:

- conv tensors are (batch, chans, *spatial) inside the model; ConvUNetR
  permutes its channels-last input once at entry, which leaves the data in
  PyTorch's channels_last(_3d) memory format, the layout cuDNN prefers;
- parameters stay float32 and every Linear/Conv computes in the dtype of its
  input (bf16 activations on the card), like flax's ``dtype`` argument;
- norms take float32 statistics and return the input's dtype;
- GELU is torch's exact erf form (the JAX package uses an Abramowitz-Stegun
  erf, abs err 1.5e-7, which the parity tolerances absorb).

Only the plain convolutions are ported: the JAX package's z-fold and g-fold
rewrites (``_ZFoldConv3``, ``_ZFoldConvT``, ``_FoldedClassMajorHead``, and the
``segments`` argument of its LayerNorm that serves them) are TPU
lane-padding layouts of the same ops with the same parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

KernelSize = Union[int, Sequence[int]]

gelu = F.gelu


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class ConvLayerNorm(LayerNorm):
    """LayerNorm over the channel axis of (batch, chans, *spatial)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


def get_conv_norm(norm: str, n_chans: int, eps: float = 1e-6) -> nn.Module:
    """Norm of the conv blocks (reference conv.py:190-209); the port has 'layer' only."""
    if norm != "layer":
        raise NotImplementedError(f"Conv norm {norm!r} is not ported; only 'layer' is.")
    return ConvLayerNorm(n_chans, eps=eps)


class Dense(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class _CastConv:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


class _CastConvTranspose:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        fn = F.conv_transpose2d if x.ndim == 4 else F.conv_transpose3d
        return fn(x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.output_padding,
                  self.groups, self.dilation)


class ConvTranspose2d(_CastConvTranspose, nn.ConvTranspose2d):
    pass


class ConvTranspose3d(_CastConvTranspose, nn.ConvTranspose3d):
    pass


def Conv(nd: int, in_chans: int, out_chans: int, kernel_size: KernelSize, **kwargs) -> nn.Module:
    """N-d convolution (nd in {2, 3}) computing in its input's dtype."""
    return {2: Conv2d, 3: Conv3d}[nd](in_chans, out_chans, kernel_size, **kwargs)


def ConvTranspose(nd: int, in_chans: int, out_chans: int, kernel_size: Sequence[int]) -> nn.Module:
    """Upsampling transposed convolution with stride == kernel size."""
    kernel_size = tuple(kernel_size)
    cls = {2: ConvTranspose2d, 3: ConvTranspose3d}[nd]
    return cls(in_chans, out_chans, kernel_size, stride=kernel_size)


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity in eval mode."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep_prob = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.rand(shape, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ConvMlp(nn.Module):
    """MLP of 1x1 convs (reference conv.py:111-166)."""

    def __init__(self, nd: int, chans: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = Conv(nd, chans, hidden, 1)
        self.fc2 = Conv(nd, hidden, chans, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class ConvNormActBlock(nn.Module):
    """conv -> norm -> GELU (reference conv.py:212-273); VALID padding."""

    def __init__(self, nd: int, in_chans: int, out_chans: int, kernel_size: KernelSize,
                 stride: KernelSize = 1, norm: str = "layer") -> None:
        super().__init__()
        self.conv = Conv(nd, in_chans, out_chans, kernel_size, stride=stride)
        self.norm = get_conv_norm(norm, out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.norm(self.conv(x)))


class ConvResBlock(nn.Module):
    """norm-act-conv x2 + 1x1 shortcut when the width changes (reference conv.py:276-346)."""

    def __init__(self, nd: int, in_chans: int, out_chans: int, kernel_size: int = 3,
                 dropout: float = 0.0, norm: str = "layer") -> None:
        super().__init__()
        self.norm1 = get_conv_norm(norm, in_chans)
        self.conv1 = Conv(nd, in_chans, out_chans, kernel_size, padding="same")
        self.norm2 = get_conv_norm(norm, out_chans)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv(nd, out_chans, out_chans, kernel_size, padding="same")
        self.shortcut = Conv(nd, in_chans, out_chans, 1) if in_chans != out_chans else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(gelu(self.norm1(x)))
        h = self.conv2(self.dropout(gelu(self.norm2(h))))
        return h + self.shortcut(x)


class MaskedConvBlock(nn.Module):
    """ConvMAE block with the mask multiply (reference conv.py:349-415):
    x += drop_path(conv2(dw_conv5(mask * conv1(norm1(x))))); x += drop_path(mlp(norm2(x))).

    The mask multiply keeps masked-patch pixels from leaking through the
    5^nd depthwise conv, the only op of the block that crosses positions.
    """

    def __init__(self, nd: int, chans: int, mlp_ratio: int = 4, drop_path: float = 0.0,
                 norm: str = "layer") -> None:
        super().__init__()
        self.norm1 = get_conv_norm(norm, chans)
        self.conv1 = Conv(nd, chans, chans, 1)
        self.dw_conv = Conv(nd, chans, chans, 5, padding="same", groups=chans)
        self.conv2 = Conv(nd, chans, chans, 1)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = get_conv_norm(norm, chans)
        self.mlp = ConvMlp(nd, chans, chans * mlp_ratio)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, dense_ctx=None) -> torch.Tensor:
        """x: (batch, chans, *spatial); mask: (batch, *spatial), True or 1 = visible.

        With ``dense_ctx`` (ops.sparse_cells.CellDenseCtx) x holds the visible
        cells only, (batch * k, chans, *cell): the depthwise conv runs on the
        densified image and the scatter's zeros at masked cells play the mask
        multiply's part, so ``mask`` must be None then.
        """
        if dense_ctx is not None and mask is not None:
            raise ValueError("mask and dense_ctx are mutually exclusive.")
        h = self.conv1(self.norm1(x))
        if mask is not None:
            h = h * mask[:, None].to(h.dtype)
        if dense_ctx is not None:
            h = dense_ctx.densify(h)
        h = self.dw_conv(h)
        if dense_ctx is not None:
            h = dense_ctx.sparsify(h)
        x = x + self.drop_path1(self.conv2(h))
        return x + self.drop_path2(self.mlp(self.norm2(x)))
