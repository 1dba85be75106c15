"""The frozen arithmetic of the per-layer metrics: the chip's peaks, the attention work of a unit
from the configuration's shapes, and the model's operations counted on the plain reference.

Peaks: one NVIDIA H100 SXM (the data sheet's dense rates at 700 W): 989e12 flop/s in bf16 on the
tensor cores and 3.35e12 bytes/s of HBM.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from perfbench.harness.weights import on_meta
from perfbench.reference import models as ref

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2

# (batch, query tokens, key tokens, embed, forward and backward?) per attention layer of one unit
AttentionCall = Tuple[int, int, int, int, bool]


def attention_calls(cfg: dict, step: str, batch: int, train: bool) -> List[AttentionCall]:
    """The attention layers that one unit of ``step`` runs, at the configuration's shapes."""
    if step == "mae":
        m, vit = cfg["model"], ref.vit_widths(cfg["model"])
        ratio = cfg["train"]["enc_mask_ratio"]
        keep = masked = 0
        for v in m["views"]:
            data = cfg["data"]["sax" if v == "sax" else "lax"]
            nd = len(data["patch_size"])
            eff = [p * s ** len(m["enc_conv_chans"]) for p, s in zip(m["patch_size"][:nd], m["scale_factor"][:nd])]
            n = math.prod(s // e for s, e in zip(data["patch_size"], eff))
            keep += int(n * (1 - ratio))
            masked += n - int(n * (1 - ratio))
        enc = [(batch, 1 + keep, 1 + keep, vit["enc_embed_dim"], train)] * vit["enc_depth"]
        dec = [(batch, 1 + masked, keep, vit["dec_embed_dim"], train)] * vit["dec_depth"]
        return enc + dec
    m = cfg["model"]["convunetr"]
    vit = ref.vit_widths(m)
    eff = [p * s ** len(m["enc_conv_chans"]) for p, s in zip(m["enc_patch_size"], m["enc_scale_factor"])]
    n = math.prod(s // e for s, e in zip(cfg["data"]["sax"]["patch_size"], eff))
    return [(batch, 1 + n, 1 + n, vit["enc_embed_dim"], train)] * vit["enc_depth"]


def attention_flop_bytes(call: AttentionCall) -> Tuple[float, float]:
    """Forward: 4 B Tq Tk E flop, q k v out read or written once; backward: 10 B Tq Tk E flop and
    q k v o g dq dk dv, in bf16."""
    b, tq, tk, e, train = call
    flop = 4.0 * b * tq * tk * e
    nbytes = (2 * b * tq * e + 2 * b * tk * e) * BF16_BYTES
    if train:
        flop += 10.0 * b * tq * tk * e
        nbytes += (4 * b * tq * e + 4 * b * tk * e) * BF16_BYTES
    return flop, nbytes


def attention_min_s(calls: List[AttentionCall]) -> float:
    """The least time the attention work of ``calls`` can take: per call the larger of its flop at
    the bf16 peak and its bytes at the HBM peak."""
    total = 0.0
    for call in calls:
        flop, nbytes = attention_flop_bytes(call)
        total += max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return total


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                       _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """A convolution's backward: each gradient asked for (input, weight) costs the forward's operations.
    Replaces torch's formula, which counts a grouped (depthwise) convolution's weight gradient as if
    the convolution were dense."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def model_flop(cfg: dict, step: str, batch: int, train: bool) -> float:
    """Floating-point operations of one unit (``batch`` rows) of the plain reference, forward and, with
    ``train``, backward, counted by ``FlopCounterMode`` on the meta device: no recomputation, and
    the stems dense as published."""
    from torch.utils.flop_counter import FlopCounterMode

    model = on_meta(step, cfg)
    model.train(train)
    meta = torch.device("meta")
    if step == "mae":
        images, masks = {}, {}
        for v in model.views:
            data = cfg["data"]["sax" if v == "sax" else "lax"]
            images[v] = torch.empty((batch, *data["patch_size"], data["in_chans"]), device=meta)
            n = model.enc_down_dict[v].n_patches
            k = int(n * (1 - cfg["train"]["enc_mask_ratio"]))
            masks[v] = {"visible": torch.empty((batch, n), dtype=torch.bool, device=meta),
                        "keep": torch.empty((batch, k), dtype=torch.long, device=meta),
                        "masked": torch.empty((batch, n - k), dtype=torch.long, device=meta)}
        run = lambda: model(images, masks)  # noqa: E731
    else:
        data = cfg["data"]["sax"]
        image = torch.empty((batch, *data["patch_size"], data["in_chans"]), device=meta)
        labels = torch.empty((batch, *data["patch_size"]), dtype=torch.long, device=meta)
        model.eval()  # no noise on meta; dropout adds no operation that the counter counts
        run = lambda: ref.segmentation_loss(model(image), labels)  # noqa: E731
    counter = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flop})
    with counter:
        out = run()
        if train:
            out.backward()
    return float(counter.get_total_flops())

