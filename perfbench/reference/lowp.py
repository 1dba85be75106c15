"""The arithmetic of the reference's products: float32 as stated, or an emulated lower precision.

``Exact`` hands the operands of every matrix product and convolution through unchanged; the
reference then computes in float32 (TF32 off: :func:`float32_products`). ``FP8`` rounds them to
float8 e4m3 on the way in and the gradients that reach them to e5m2 on the way back, each with a
per-tensor scale that maps its largest magnitude to the format's largest value, as fp8 training
does. It is the control: the step below the bfloat16 that the configurations state.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch


@contextmanager
def float32_products() -> Iterator[None]:
    """Matrix products and convolutions in true float32 (no TF32) inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class Exact:
    """Operands as they are."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _FP8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _round_to(g, torch.float8_e5m2)


class FP8:
    """Operands rounded to e4m3, their gradients to e5m2, per-tensor scaled."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _FP8Round.apply(x)

