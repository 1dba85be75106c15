"""Plain PyTorch CineMA (masked autoencoder) and ConvUNetR, the benchmark's reference.

Written from the published models (github.com/mathpluscode/CineMA: cinema/mae/mae.py, cinema/convvit.py,
cinema/conv.py, cinema/vit.py, cinema/segmentation/convunetr.py) and imports nothing of the program.
Attention is the textbook softmax(q k^T / sqrt(d)) v, the conv stems run densely with the mask
multiplied in (as the published MAE does), every tensor is float32 and every matrix product and
convolution hands its operands through the model's ``lowp`` rounding (``reference.lowp``).
Parameter names are those of the published checkpoints, so one state dict loads into either side.

The stochastic layers draw from ``Noise``: each draw is made for the whole batch, in the order of
the forward pass, and a model run on a block of rows keeps its rows of it, so a batch computed in
blocks sees the noise of the batch computed at once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.lowp import Exact


class Noise:
    """The generator the stochastic layers draw from, the batch each draw covers and the rows kept."""

    def __init__(self) -> None:
        self.gen: Optional[torch.Generator] = None
        self.batch = 0
        self.rows = slice(None)

    def rand(self, shape: Sequence[int], device: torch.device) -> torch.Tensor:
        full = torch.rand((self.batch, *shape[1:]), device=device, generator=self.gen)
        return full[self.rows]


class Ref(nn.Module):
    """Base of the reference's modules: the rounding of its products and the noise source."""

    lowp = Exact()
    noise = Noise()


def _q(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module.lowp(x)


class Linear(nn.Linear, Ref):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_q(self, x), _q(self, self.weight), self.bias)


class ConvNd(Ref):
    """An N-d convolution with ``weight`` (out, in / groups, *k) and ``bias`` (out,)."""

    def __init__(self, nd: int, cin: int, cout: int, kernel, stride=1, padding=0, groups: int = 1) -> None:
        super().__init__()
        kernel = (kernel,) * nd if isinstance(kernel, int) else tuple(kernel)
        self.nd, self.stride, self.padding, self.groups = nd, stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = F.conv3d if self.nd == 3 else F.conv2d
        return fn(_q(self, x), _q(self, self.weight), self.bias, self.stride, self.padding, 1, self.groups)


class ConvTransposeNd(Ref):
    """Transposed convolution with stride == kernel, ``weight`` (in, out, *k)."""

    def __init__(self, nd: int, cin: int, cout: int, kernel: Sequence[int]) -> None:
        super().__init__()
        self.nd, self.kernel = nd, tuple(kernel)
        self.weight = nn.Parameter(torch.empty(cin, cout, *self.kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = F.conv_transpose3d if self.nd == 3 else F.conv_transpose2d
        return fn(_q(self, x), _q(self, self.weight), self.bias, self.kernel)


class ChanNorm(nn.LayerNorm):
    """LayerNorm over the channel axis of (batch, chans, *spatial)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


def conv_norm(chans: int) -> ChanNorm:
    return ChanNorm(chans, eps=1e-6)


class DropPath(Ref):
    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep_prob = 1.0 - self.rate
        keep = self.noise.rand((x.shape[0],) + (1,) * (x.ndim - 1), x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Dropout(Ref):
    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep_prob = 1.0 - self.rate
        return x * (self.noise.rand(x.shape, x.device) < keep_prob).float() / keep_prob


# ---------------------------------------------------------------- conv blocks (cinema/conv.py)


class ConvNormAct(nn.Module):
    def __init__(self, nd: int, cin: int, cout: int, kernel: Sequence[int]) -> None:
        super().__init__()
        self.conv = ConvNd(nd, cin, cout, kernel, stride=tuple(kernel))
        self.norm = conv_norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv(x)))


class ConvMlp(nn.Module):
    def __init__(self, nd: int, chans: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = ConvNd(nd, chans, hidden, 1)
        self.fc2 = ConvNd(nd, hidden, chans, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class MaskedConvBlock(nn.Module):
    """x += conv2(dw5(mask * conv1(norm1(x)))); x += mlp(norm2(x))."""

    def __init__(self, nd: int, chans: int) -> None:
        super().__init__()
        self.norm1 = conv_norm(chans)
        self.conv1 = ConvNd(nd, chans, chans, 1)
        self.dw_conv = ConvNd(nd, chans, chans, 5, padding=2, groups=chans)
        self.conv2 = ConvNd(nd, chans, chans, 1)
        self.norm2 = conv_norm(chans)
        self.mlp = ConvMlp(nd, chans, chans * 4)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if mask is not None:
            h = h * mask[:, None].float()
        x = x + self.conv2(self.dw_conv(h))
        return x + self.mlp(self.norm2(x))


class ConvResBlock(nn.Module):
    """norm-gelu-conv, norm-gelu-dropout-conv, plus a 1x1 shortcut where the width changes."""

    def __init__(self, nd: int, cin: int, cout: int, dropout: float) -> None:
        super().__init__()
        self.norm1 = conv_norm(cin)
        self.conv1 = ConvNd(nd, cin, cout, 3, padding=1)
        self.norm2 = conv_norm(cout)
        self.dropout = Dropout(dropout)
        self.conv2 = ConvNd(nd, cout, cout, 3, padding=1)
        self.shortcut = ConvNd(nd, cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.gelu(self.norm1(x)))
        h = self.conv2(self.dropout(F.gelu(self.norm2(h))))
        return h + self.shortcut(x)


# ---------------------------------------------------------------- ViT (cinema/vit.py)


# The size presets (cinema/vit.py:784-831): the encoder's and the decoder's width, depth and heads.
VIT = {
    "tiny": dict(enc_embed_dim=16, enc_depth=1, enc_n_heads=2, dec_embed_dim=16, dec_depth=1, dec_n_heads=2),
    "base": dict(enc_embed_dim=768, enc_depth=12, enc_n_heads=12, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
    "large": dict(enc_embed_dim=1024, enc_depth=24, enc_n_heads=16, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
    "huge": dict(enc_embed_dim=1280, enc_depth=32, enc_n_heads=16, dec_embed_dim=512, dec_depth=8, dec_n_heads=16),
}


def vit_widths(model: dict) -> Dict[str, int]:
    """The preset that a configuration's model block (``model``, or ``model.convunetr``) names by its ``size``."""
    size = model["size"]
    if size not in VIT:
        raise ValueError(f"The model size must be one of {list(VIT)}, got {size!r}.")
    return VIT[size]


def sincos_pos_embed(dim: int, grid_size: Sequence[int]) -> np.ndarray:
    """(prod(grid), dim) float32: per axis dim // n (floored to even) of sin | cos, the rest zeros;
    the position grid of np.meshgrid's default 'xy' indexing, as the published code builds it."""
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in grid_size]), axis=0)
    n = grid.shape[0]
    d = dim // n
    d -= d % 2
    parts = []
    for i in range(n):
        omega = np.exp(-np.log(10000) * np.arange(d // 2, dtype=np.float32) / (d // 2))
        out = np.einsum("m,d->md", grid[i].reshape(-1), omega)
        parts.append(np.concatenate([np.sin(out), np.cos(out)], axis=1))
    emb = np.concatenate(parts, axis=1)
    if dim > d * n:
        emb = np.concatenate([emb, np.zeros((emb.shape[0], dim - d * n))], axis=1)
    return emb.astype(np.float32)


def patchify(image: torch.Tensor, patch: Sequence[int]) -> torch.Tensor:
    """(batch, *spatial, c) -> (batch, n_patches, prod(patch) * c), patches row-major, c fastest."""
    b, *spatial, c = image.shape
    nd = len(patch)
    shape = [b]
    for s, p in zip(spatial, patch):
        shape += [s // p, p]
    x = image.reshape(*shape, c)
    perm = [0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)] + [1 + 2 * nd]
    return x.permute(perm).reshape(b, -1, math.prod(patch) * c)


def gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        return x[ids]
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


class Attention(Ref):
    def __init__(self, dim: int, n_heads: int) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, k: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, dim = x.shape
        h, d = self.n_heads, dim // self.n_heads
        kv = self.kv(x if k is None else k)
        q = self.q(x).reshape(b, n, h, d).transpose(1, 2)
        kv = kv.reshape(b, kv.shape[1], 2, h, d)
        key, value = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        scores = torch.matmul(_q(self, q), _q(self, key).transpose(-1, -2)) * d**-0.5
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(_q(self, probs), _q(self, value))
        return self.proj(out.transpose(1, 2).reshape(b, n, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, n_heads: int, drop_path: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, n_heads)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, 4 * dim)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, k: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x), k))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class Encoder(nn.Module):
    def __init__(self, dim: int, depth: int, n_heads: int, drop_path: float) -> None:
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.blocks = nn.ModuleList(Block(dim, n_heads, drop_path) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class Decoder(nn.Module):
    def __init__(self, dim: int, depth: int, n_heads: int) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, n_heads, 0.0) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, q: torch.Tensor, k: torch.Tensor, n_out: int) -> torch.Tensor:
        for block in self.blocks:
            q = block(q, k)
        return self.norm(q[:, -n_out:])


# ---------------------------------------------------------------- ConvMAE stem (cinema/convvit.py)


class PatchEmbed(nn.Module):
    def __init__(self, patch: Sequence[int], cin: int, dim: int) -> None:
        super().__init__()
        self.patch = tuple(patch)
        self.proj = Linear(cin * math.prod(patch), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(patchify(x.movedim(1, -1), self.patch))


class Stem(nn.Module):
    """Per level a strided conv-norm-GELU and ``n_blocks`` masked conv blocks; then the patch embed,
    a linear layer and the sincos table."""

    def __init__(self, image: Sequence[int], cin: int, patch: Sequence[int], scale: Sequence[int],
                 chans: Sequence[int], n_blocks: int, dim: int) -> None:
        super().__init__()
        nd = len(image)
        self.patches = [tuple(patch)] + [tuple(scale)] * len(chans)
        self.eff = tuple(math.prod(p[i] for p in self.patches) for i in range(nd))
        self.grid = tuple(s // e for s, e in zip(image, self.eff))
        self.n_patches = math.prod(self.grid)
        blocks, c = [], cin
        for p, ch in zip(self.patches[:-1], chans):
            block = nn.Module()
            block.patch_embed = ConvNormAct(nd, c, ch, p)
            block.conv = nn.ModuleList(MaskedConvBlock(nd, ch) for _ in range(n_blocks))
            blocks.append(block)
            c = ch
        self.conv_blocks = nn.ModuleList(blocks)
        self.patch_embed = PatchEmbed(self.patches[-1], c, dim)
        self.linear = Linear(dim, dim)
        self.register_buffer("pos", torch.from_numpy(sincos_pos_embed(dim, self.grid)), persistent=False)

    def forward(self, x: torch.Tensor, visible: Optional[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x: (batch, c, *spatial); visible: (batch, n_patches) bool or None."""
        masks: List[Optional[torch.Tensor]] = [None] * len(self.conv_blocks)
        if visible is not None:
            masks = []
            m = visible.reshape(visible.shape[0], *self.grid)
            for p in self.patches[:0:-1]:
                for axis, f in enumerate(p):
                    m = m.repeat_interleave(f, dim=axis + 1)
                masks.insert(0, m)
        skips = []
        for block, mask in zip(self.conv_blocks, masks):
            x = block.patch_embed(x)
            for conv in block.conv:
                x = conv(x, mask)
            skips.append(x)
        return skips, self.linear(self.patch_embed(x)) + self.pos


class Fusion(nn.Module):
    def __init__(self, image: Sequence[int], patch: Sequence[int], scale: Sequence[int],
                 chans: Sequence[int], dim: int) -> None:
        super().__init__()
        nd = len(image)
        patches = [tuple(patch)] + [tuple(scale)] * len(chans)
        sizes, size = [], tuple(image)
        for p in patches[:-1]:
            size = tuple(s // q for s, q in zip(size, p))
            sizes.append(size)
        grid = tuple(s // q for s, q in zip(size, patches[-1]))
        self.down_convs = nn.ModuleList(
            ConvNd(nd, ch, dim, tuple(s // g for s, g in zip(sz, grid)), stride=tuple(s // g for s, g in zip(sz, grid)))
            for sz, ch in zip(sizes, chans)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, skips: List[torch.Tensor], x: torch.Tensor, keep_ids: Optional[torch.Tensor]) -> torch.Tensor:
        for skip, conv in zip(skips, self.down_convs):
            down = conv(skip).flatten(2).transpose(1, 2)
            x = x + (down if keep_ids is None else gather(down, keep_ids))
        return self.norm(x)


# ---------------------------------------------------------------- CineMA (cinema/mae/mae.py)


def draw_masks(gen: torch.Generator, rows: int, n_patches: int, ratio: float, device) -> Dict[str, torch.Tensor]:
    """A view's mask: the published argsort of U[0, 1) noise, the first int(n (1 - ratio)) kept, ids sorted."""
    n_keep = int(n_patches * (1 - ratio))
    noise = torch.rand((rows, n_patches), generator=gen, device=gen.device).to(device)
    order = torch.argsort(noise, dim=1)
    keep = torch.sort(order[:, :n_keep], dim=1).values
    masked = torch.sort(order[:, n_keep:], dim=1).values
    visible = torch.zeros((rows, n_patches), dtype=torch.bool, device=keep.device)
    visible.scatter_(1, keep, True)
    return {"visible": visible, "keep": keep, "masked": masked}


class CineMA(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        m, vit = cfg["model"], vit_widths(cfg["model"])
        self.views = list(m["views"])
        self.images, self.dec_patch = {}, {}
        stems, fusions, heads, tokens = {}, {}, {}, {}
        for v in self.views:
            data = cfg["data"]["sax" if v == "sax" else "lax"]
            nd = len(data["patch_size"])
            patch, scale = m["patch_size"][:nd], m["scale_factor"][:nd]
            self.images[v] = tuple(data["patch_size"])
            stems[v] = Stem(data["patch_size"], data["in_chans"], patch, scale, m["enc_conv_chans"],
                            m["enc_conv_n_blocks"], vit["enc_embed_dim"])
            fusions[v] = Fusion(data["patch_size"], patch, scale, m["enc_conv_chans"], vit["enc_embed_dim"])
            self.dec_patch[v] = stems[v].eff
            tokens[v] = nn.Module()
            tokens[v].mask_token = nn.Parameter(torch.empty(1, 1, vit["dec_embed_dim"]))
            tokens[v].register_buffer("pos", torch.from_numpy(sincos_pos_embed(vit["dec_embed_dim"], stems[v].grid)),
                                      persistent=False)
            heads[v] = Linear(vit["dec_embed_dim"], math.prod(stems[v].eff) * data["in_chans"])
        self.enc_down_dict = nn.ModuleDict(stems)
        self.enc_fusion_dict = nn.ModuleDict(fusions)
        self.encoder = Encoder(vit["enc_embed_dim"], vit["enc_depth"], vit["enc_n_heads"], 0.0)
        self.dec_linear = Linear(vit["enc_embed_dim"], vit["dec_embed_dim"])
        self.dec_embed_dict = nn.ModuleDict(tokens)
        self.decoder = Decoder(vit["dec_embed_dim"], vit["dec_depth"], vit["dec_n_heads"])
        self.pred_head_dict = nn.ModuleDict(heads)

    def forward(self, images: Dict[str, torch.Tensor], masks: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
        """images: (batch, *spatial, c) per view; masks: :func:`draw_masks` per view. Returns the loss:
        the mean over views of the mean squared error on the masked patches."""
        xs, skips = [], []
        for v in self.views:
            s, x = self.enc_down_dict[v](images[v].movedim(-1, 1), masks[v]["visible"])
            skips.append(s)
            xs.append(gather(x, masks[v]["keep"]))
        n_keep = [x.shape[1] for x in xs]
        x = self.encoder(torch.cat(xs, dim=1))
        parts = list(torch.split(x, [1, *n_keep], dim=1))
        for i, v in enumerate(self.views):
            parts[i + 1] = self.enc_fusion_dict[v](skips[i], parts[i + 1], masks[v]["keep"])
        parts = list(torch.split(self.dec_linear(torch.cat(parts, dim=1)), [1, *n_keep], dim=1))
        vis, hidden = [], []
        for i, v in enumerate(self.views):
            emb = self.dec_embed_dict[v]
            vis.append(parts[i + 1] + gather(emb.pos, masks[v]["keep"]))
            hidden.append(emb.mask_token + gather(emb.pos, masks[v]["masked"]))
        n_masked = [h.shape[1] for h in hidden]
        out = self.decoder(torch.cat([parts[0], *hidden], dim=1), torch.cat(vis, dim=1), sum(n_masked))
        losses = []
        for v, pred in zip(self.views, torch.split(out, n_masked, dim=1)):
            target = gather(patchify(images[v], self.dec_patch[v]), masks[v]["masked"])
            losses.append(torch.mean(torch.square(self.pred_head_dict[v](pred) - target)))
        return torch.stack(losses).mean()


# ---------------------------------------------------------------- ConvUNetR (cinema/segmentation/convunetr.py)


class UpDecoder(nn.Module):
    def __init__(self, nd: int, chans: Sequence[int], patch: Sequence[int], scale: Sequence[int],
                 dropout: float) -> None:
        super().__init__()
        blocks = []
        for i, ch in enumerate(chans[::-1]):
            last = i == len(chans) - 1
            out = ch if last else chans[-i - 2]
            block = nn.Module()
            block.up = ConvTransposeNd(nd, ch, out, patch if last else scale)
            block.conv = nn.ModuleList(ConvResBlock(nd, out, out, dropout) for _ in range(2))
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, embeddings: List[Optional[torch.Tensor]]) -> torch.Tensor:
        embeddings = list(embeddings)
        x = embeddings.pop()
        for block in self.blocks:
            x = block.up(x)
            skip = embeddings.pop()
            if skip is not None:
                x = x + skip
            for conv in block.conv:
                x = conv(x)
        return x


class ConvUNetR(nn.Module):
    """One 3-D view (``sax``): stem, ViT encoder, strided downsamples, skip adapters, the
    transposed-conv decoder and a 1x1 head; logits (batch, *spatial, classes)."""

    def __init__(self, cfg: dict) -> None:
        super().__init__()
        m = cfg["model"]["convunetr"]
        vit = vit_widths(m)
        data = cfg["data"]["sax"]
        nd, dim = 3, vit["enc_embed_dim"]
        dec, dec_patch, scale = list(m["dec_chans"]), tuple(m["dec_patch_size"]), tuple(m["dec_scale_factor"])
        enc_factor = tuple(p * s ** len(m["enc_conv_chans"]) for p, s in zip(m["enc_patch_size"], m["enc_scale_factor"]))
        factor, no_skip, n_down = dec_patch, None, None
        for i in range(len(dec)):
            if factor == tuple(m["enc_patch_size"]):
                no_skip = i
            if factor == enc_factor:
                n_down = len(dec) - 1 - i
            factor = tuple(f * s for f, s in zip(factor, scale))
        self.no_skip = no_skip
        self.enc_down_dict = nn.ModuleDict({"sax": Stem(data["patch_size"], data["in_chans"], m["enc_patch_size"],
                                                        m["enc_scale_factor"], m["enc_conv_chans"],
                                                        m["enc_conv_n_blocks"], dim)})
        self.encoder = Encoder(dim, vit["enc_depth"], vit["enc_n_heads"], m["drop_path"])
        self.dec_image_conv_block_dict = nn.ModuleDict({"sax": ConvResBlock(nd, data["in_chans"], dec[0], m["dropout"])})
        self.dec_down_blocks_dict = nn.ModuleDict({"sax": nn.ModuleList(
            ConvNd(nd, dim, dim, scale, stride=scale) for _ in range(n_down))})
        skip_chans = list(m["enc_conv_chans"]) + [dim] * (n_down + 1)
        self.dec_conv_blocks_dict = nn.ModuleDict({"sax": nn.ModuleList(
            ConvResBlock(nd, ch, dec[no_skip + i], m["dropout"]) for i, ch in enumerate(skip_chans))})
        self.decoder_dict = nn.ModuleDict({"sax": UpDecoder(nd, dec, dec_patch, scale, m["dropout"])})
        self.pred_head_dict = nn.ModuleDict({"sax": ConvNd(nd, dec[0], cfg["model"]["out_chans"], 1)})

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (batch, *spatial, c) -> logits (batch, *spatial, classes)."""
        x_in = image.movedim(-1, 1)
        stem = self.enc_down_dict["sax"]
        skips, x = stem(x_in, None)
        x = self.encoder(x)[:, 1:]
        x = x.reshape(x.shape[0], *stem.grid, x.shape[-1]).movedim(-1, 1)
        skips = [*skips, x]
        for block in self.dec_down_blocks_dict["sax"]:
            x = block(x)
            skips.append(x)
        embeddings: List[Optional[torch.Tensor]] = [self.dec_image_conv_block_dict["sax"](x_in)]
        embeddings += [None] * self.no_skip
        for j, block in enumerate(self.dec_conv_blocks_dict["sax"]):
            embeddings.append(block(skips[j]))
        out = self.pred_head_dict["sax"](self.decoder_dict["sax"](embeddings))
        return out.movedim(1, -1)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy (label -1 ignored) plus the mean over batch and foreground classes of 1 - soft
    Dice (MONAI's smoothing 1e-5), on float32 softmax; labels (batch, *spatial)."""
    n = logits.shape[-1]
    labels = labels.long()
    valid = labels != -1
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.clamp(min=0), n).float()
    ce = -(onehot * logp).sum(-1)
    ce = torch.where(valid, ce, torch.zeros_like(ce)).sum() / valid.sum().clamp(min=1)
    probs, target = torch.softmax(logits.float(), dim=-1)[..., 1:], onehot[..., 1:]
    axes = tuple(range(1, probs.ndim - 1))
    dice = (2.0 * (probs * target).sum(axes) + 1e-5) / (probs.sum(axes) + target.sum(axes) + 1e-5)
    return ce + (1.0 - dice).mean()


MODELS = {"mae": CineMA, "segmentation": ConvUNetR}


def set_lowp(model: nn.Module, lowp) -> None:
    """Route every product of ``model`` through ``lowp``."""
    for module in model.modules():
        if isinstance(module, Ref):
            module.lowp = lowp


def set_noise(model: nn.Module, noise: Noise) -> None:
    for module in model.modules():
        if isinstance(module, Ref):
            module.noise = noise
