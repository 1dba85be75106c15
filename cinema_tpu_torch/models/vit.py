"""Vision Transformer core (port of cinema_tpu/models/vit.py; reference cinema/vit.py).

Attention keeps the packed (batch, tokens, embed) layout: q and the fused kv
projection feed the packed flash-attention kernel directly, k and v being
column slices of kv, so no (batch, heads, tokens, head_dim) copy is made.
Module names follow the reference checkpoints (blocks.{i}.attn.{q,kv,proj},
blocks.{i}.mlp.{fc1,fc2}).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from cinema_tpu_torch.models.layers import Dense, DropPath, LayerNorm, gelu
from cinema_tpu_torch.ops.flash_attention import flash_attention_packed
from cinema_tpu_torch.ops.patch import patchify


def get_vit_config(size: str) -> dict[str, int]:
    """ViT size presets (reference vit.py:784-831)."""
    configs = {
        "tiny": dict(enc_embed_dim=16, enc_depth=1, enc_n_heads=2, dec_embed_dim=16, dec_depth=1, dec_n_heads=2),
        "base": dict(enc_embed_dim=768, enc_depth=12, enc_n_heads=12, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
        "large": dict(enc_embed_dim=1024, enc_depth=24, enc_n_heads=16, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
        "huge": dict(enc_embed_dim=1280, enc_depth=32, enc_n_heads=16, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
    }
    if size not in configs:
        raise ValueError(f"size must be in ['tiny', 'base', 'large', 'huge'], got {size}.")
    return configs[size]


class PatchEmbed(nn.Module):
    """Patchify + Dense (reference vit.py:259-344), on a (batch, chans, *spatial) input."""

    def __init__(self, image_size: Sequence[int], patch_size: Sequence[int], in_chans: int,
                 embed_dim: int) -> None:
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.grid_size = tuple(s // p for s, p in zip(image_size, patch_size))
        self.proj = Dense(in_chans * math.prod(self.patch_size), embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, chans, *spatial) -> (batch, n_patches, embed_dim)."""
        return self.proj(patchify(x.movedim(1, -1), self.patch_size))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """Self/cross attention with separate q and fused kv projections
    (reference vit.py:446-522) through the packed flash-attention kernel.

    The kernel has no qk_norm, rotary or attention dropout; those
    configurations need the per-head kernel (`_flash_forward`, ROADMAP.md
    Queue 2, kernel row 1) and raise NotImplementedError until it is ported.
    """

    def __init__(self, dim: int, n_heads: int, qkv_bias: bool = True, qk_norm: bool = False,
                 rotary: bool = False, attn_drop: float = 0.0) -> None:
        super().__init__()
        if dim % n_heads != 0:
            raise ValueError(f"dim {dim} should be divisible by n_heads {n_heads}")
        if qk_norm or rotary:
            raise NotImplementedError(
                "qk_norm and rotary attention need the per-head flash kernel (_flash_forward), "
                "not ported yet: ROADMAP.md Queue 2, kernel row 1."
            )
        self.n_heads = n_heads
        self.attn_drop = attn_drop
        self.q = Dense(dim, dim, bias=qkv_bias)
        self.kv = Dense(dim, dim * 2, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, q: torch.Tensor, k: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q: (batch, n_q, dim); k: optional (batch, n_k, dim) for cross-attention."""
        if self.training and self.attn_drop > 0.0:
            raise NotImplementedError(
                "attention dropout needs the per-head flash kernel with dropout, "
                "not ported yet: ROADMAP.md Queue 2, kernel row 1."
            )
        dim = q.shape[-1]
        kv = self.kv(q if k is None else k)
        # the fused kv projection orders outputs (2, n_heads, head_dim)
        x = flash_attention_packed(self.q(q), kv[..., :dim], kv[..., dim:], self.n_heads)
        return self.proj(x)


class Block(nn.Module):
    """Pre-norm transformer block (reference vit.py:525-609)."""

    def __init__(self, dim: int, n_heads: int, mlp_ratio: float = 4, qkv_bias: bool = True,
                 norm_eps: float = 1e-5, drop_path: float = 0.0) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, n_heads, qkv_bias=qkv_bias)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path2 = DropPath(drop_path)

    def forward(self, q: torch.Tensor, k: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = q + self.drop_path1(self.attn(self.norm1(q), k))
        return q + self.drop_path2(self.mlp(self.norm2(q)))


class ViTEncoder(nn.Module):
    """Prepend the cls token, N blocks, final norm (reference vit.py:612-698)."""

    def __init__(self, embed_dim: int, depth: int, n_heads: int, mlp_ratio: float = 4,
                 qkv_bias: bool = True, norm_eps: float = 1e-5, drop_path: float = 0.0) -> None:
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, n_heads, mlp_ratio, qkv_bias, norm_eps, drop_path) for _ in range(depth)
        )
        self.norm = LayerNorm(embed_dim, eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n, E) -> (batch, 1 + n, E)."""
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
