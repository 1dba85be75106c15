"""Per-head scaled dot-product attention dispatch (port of cinema_tpu/ops/attention.py).

Layout is (batch, tokens, heads, head_dim) throughout. Without dropout the
per-head flash-attention kernels compute it on the card
(``ops/flash_attention.py``; their plain versions on the CPU). With active
attention dropout the probabilities have to exist, so that case takes the
manual path, as in the JAX package, where it runs no kernel either.
"""

from __future__ import annotations

from typing import Optional

import torch

from cinema_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_rate: float = 0.0,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v.

    Args:
        q: (batch, n_q, heads, head_dim); k, v: (batch, n_k, heads, head_dim).
        dropout_rate: attention-probability dropout rate, active when ``training``.
        generator: draws the dropout mask (on q's device); the default generator when None.

    Returns:
        (batch, n_q, heads, head_dim).
    """
    if not (training and dropout_rate > 0.0):
        return flash_attention(q, k, v)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    keep = torch.rand(probs.shape, device=probs.device, generator=generator) < 1.0 - dropout_rate
    probs = probs * keep.to(probs.dtype) / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
