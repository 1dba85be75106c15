"""Rotary position embeddings (port of cinema_tpu/ops/rotary.py; reference cinema/rotary.py).

Per-token rotation, as the JAX package applies it: the position is the
token index along axis 1 of (batch, tokens, heads, head_dim). The cos/sin
tables are functions of the token count alone, built in float32 with numpy
and cast to the operand's dtype. The JAX package has no kernel here (plain
jnp), so this is plain torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rotary_cos_sin(
    n_tokens: int, dim: int, base: float = 10000.0, scaling_factor: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """cos and sin tables, each (n_tokens, dim // 2) float32.

    Args:
        n_tokens: sequence length.
        dim: rotary dimension (head_dim).
        base: theta base.
        scaling_factor: linear position scaling.
    """
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(n_tokens, dtype=np.float32) / scaling_factor
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) -> (-x2, x1) along the last axis."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (batch, n_tokens, heads, head_dim) by cos/sin (>= n_tokens, rotary_dim / 2)."""
    ro_dim = cos.shape[-1] * 2
    if ro_dim > x.shape[-1]:
        raise ValueError(f"Rotary dim {ro_dim} is larger than the last dimension of x {x.shape[-1]}")
    n_tokens = x.shape[1]
    # (n_tokens, d/2) -> (n_tokens, 1, d): [c, c] along the last axis
    cos = cos[:n_tokens].repeat(1, 2)[:, None, :].to(x.dtype)
    sin = sin[:n_tokens].repeat(1, 2)[:, None, :].to(x.dtype)
    x_ro = x[..., :ro_dim] * cos + rotate_half(x[..., :ro_dim]) * sin
    if ro_dim == x.shape[-1]:
        return x_ro
    return torch.cat([x_ro, x[..., ro_dim:]], dim=-1)


_tables: dict = {}


def apply_rotary(q: torch.Tensor, k: torch.Tensor, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k (batch, n_tokens, heads, head_dim), equal sequence lengths, from position ``offset``."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("q and k must have the same sequence length")
    key = (q.shape[1] + offset, q.shape[-1], str(q.device))
    if key not in _tables:
        cos, sin = rotary_cos_sin(q.shape[1] + offset, q.shape[-1])
        _tables[key] = (torch.from_numpy(cos).to(q.device), torch.from_numpy(sin).to(q.device))
    cos, sin = (x[offset:] for x in _tables[key])
    return apply_rotary_emb(q, cos, sin), apply_rotary_emb(k, cos, sin)
