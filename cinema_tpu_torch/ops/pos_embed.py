"""Sin/cos positional embeddings and resolution interpolation
(port of cinema_tpu/ops/pos_embed.py; numpy, as there).

Numerically matches the reference CineMA (vit.py:347-443), including its
quirks that determine checkpoint compatibility:

- the position grid is built with ``np.meshgrid`` default ``indexing='xy'``
  (first two axes swapped) before flattening;
- the embedding dim is split evenly over axes with an even per-axis dim and
  the remainder zero-padded.

Embeddings are host-side numpy constants, never trained; the model adds
them as tensors on its device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def get_1d_sincos_pos_embed_from_grid(
    embed_dim: int,
    grid: np.ndarray,
    max_period: int = 10000,
    dtype: np.dtype = np.float32,
) -> np.ndarray:
    """1-d sin/cos embedding for arbitrary positions.

    Args:
        embed_dim: output dim E (must be even).
        grid: positions, any shape with M elements.
        max_period: maximum frequency period.
        dtype: dtype of the frequency table.

    Returns:
        (M, E) array: first half sin, second half cos.
    """
    if embed_dim % 2 != 0:
        raise ValueError(f"Embedding dimension must be divisible by 2, got {embed_dim}.")
    half_dim = embed_dim // 2
    omega = np.arange(half_dim, dtype=dtype)
    omega = np.exp(-np.log(max_period) * omega / half_dim)
    pos = grid.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_nd_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    """N-d sin/cos embedding from an (n, ...) grid of positions.

    The embed dim is divided by the number of axes, floored to an even number,
    and any remainder is zero padded (reference vit.py:386-405).
    """
    n = grid.shape[0]
    d = embed_dim // n
    d = d - d % 2
    pad = embed_dim - d * n
    emb = np.concatenate([get_1d_sincos_pos_embed_from_grid(d, grid[i]) for i in range(n)], axis=1)
    if pad > 0:
        emb = np.concatenate([emb, np.zeros((emb.shape[0], pad))], axis=1)
    return emb


def get_nd_sincos_pos_embed(embed_dim: int, grid_size: Sequence[int]) -> np.ndarray:
    """Sin/cos positional embedding for a regular grid.

    Args:
        embed_dim: output dim E.
        grid_size: per-axis grid size.

    Returns:
        (prod(grid_size), E) float32 array. NOTE: uses np.meshgrid 'xy'
        indexing to match the reference exactly (vit.py:421).
    """
    grid = np.stack(np.meshgrid(*[np.arange(size, dtype=np.float32) for size in grid_size]), axis=0)
    return get_nd_sincos_pos_embed_from_grid(embed_dim, grid).astype(np.float32)


def _torch_resize_weights_1d(
    in_size: int, out_size: int, method: str
) -> "tuple[np.ndarray, np.ndarray]":
    """Per-output-sample source indices + weights matching torch interpolate.

    torch F.interpolate(align_corners=False): source coordinate of output i
    is (i + 0.5) * in/out - 0.5; bicubic uses the cubic-convolution kernel
    with A = -0.75,
    linear uses the 2-tap hat; out-of-range taps clamp to the border.

    Returns:
        (indices (out, taps) int, weights (out, taps) float64)
    """
    scale = in_size / out_size
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    if method == "cubic":
        a = -0.75  # torch's bicubic coefficient (aten UpSampleBicubic2d)
        x0 = np.floor(x).astype(np.int64)
        d = (x - x0)[:, None]  # fractional offset in [0, 1)
        t = np.abs(d + np.array([1.0, 0.0, -1.0, -2.0]))  # distances of the 4 taps
        w = np.where(
            t <= 1.0,
            (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
            np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
        )
        idx = x0[:, None] + np.array([-1, 0, 1, 2])
    elif method == "linear":
        x0 = np.floor(x).astype(np.int64)
        d = (x - x0)[:, None]
        w = np.concatenate([1.0 - d, d], axis=1)
        idx = x0[:, None] + np.array([0, 1])
    else:
        raise ValueError(f"Unknown method {method}.")
    return np.clip(idx, 0, in_size - 1), w


def resize_torch(array: np.ndarray, dst_sizes: Sequence[int], method: str) -> np.ndarray:
    """Separable resize of the leading axes with torch interpolate semantics
    (bicubic A=-0.75 / linear, align_corners=False, border-clamped taps).

    Args:
        array: (*src_sizes, ...extra axes).
        dst_sizes: target sizes for the first len(dst_sizes) axes.
        method: 'cubic' or 'linear'.
    """
    out = np.asarray(array, dtype=np.float64)
    for axis, dst in enumerate(dst_sizes):
        if out.shape[axis] == dst:
            continue
        idx, w = _torch_resize_weights_1d(out.shape[axis], int(dst), method)
        taken = np.take(out, idx.reshape(-1), axis=axis)
        taken = taken.reshape(out.shape[:axis] + idx.shape + out.shape[axis + 1 :])
        w_shape = (1,) * axis + idx.shape + (1,) * (out.ndim - axis - 1)
        out = (taken * w.reshape(w_shape)).sum(axis=axis + 1)
    return out


def interpolate_pos_embed(
    pos_embed: np.ndarray,
    src_grid_size: Sequence[int],
    dst_grid_size: Sequence[int],
) -> np.ndarray:
    """Resample a flattened positional embedding to a new grid size.

    Mirrors the reference DownsampleEncoder.interpolate_pos_encoding
    (convvit.py:140-163): torch bicubic (A=-0.75) for 2D, trilinear for 3D,
    align_corners=False, computed in numpy in float64 with exact torch
    semantics for off-size inputs (the sliding-window mnms2-LAX case).

    Args:
        pos_embed: (1, prod(src_grid), E) or (prod(src_grid), E) numpy array.
        src_grid_size: grid the embedding was built for.
        dst_grid_size: grid to resample to.

    Returns:
        (1, prod(dst_grid), E) float32 numpy embedding.
    """
    src_grid_size = tuple(src_grid_size)
    dst_grid_size = tuple(dst_grid_size)
    pos_embed = np.asarray(pos_embed)
    if pos_embed.ndim == 2:
        pos_embed = pos_embed[None]
    if src_grid_size == dst_grid_size:
        return pos_embed
    emb_dim = pos_embed.shape[-1]
    method = {2: "cubic", 3: "linear"}[len(src_grid_size)]
    x = pos_embed.reshape(*src_grid_size, emb_dim)
    x = resize_torch(x, dst_grid_size, method)
    return x.reshape(1, math.prod(dst_grid_size), emb_dim).astype(pos_embed.dtype)
