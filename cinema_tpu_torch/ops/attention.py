"""Per-head scaled dot-product attention in plain torch
(port of cinema_tpu/ops/attention.py, the path without dropout).

The port uses it only as a plain reference; the model's attention goes
through the packed kernel (ops/flash_attention.py).
"""

from __future__ import annotations

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (batch, tokens, heads, head_dim), f32 softmax."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
