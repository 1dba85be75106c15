"""The reference's serving: the logits of chosen frames of a (x, y, z, t) cine, in plain PyTorch.

Each frame is min-max scaled to [0, 1] in float32 (zeros where it is constant) and end-padded with
zeros to the model's input size, as the published example does (examples/inference/segmentation_sax.py);
the logits are cropped back to the frame's own size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from perfbench.reference import models as ref
from perfbench.reference.lowp import float32_products


def frame_input(video: np.ndarray, frame: int, size: Sequence[int]) -> np.ndarray:
    x = video[..., frame].astype(np.float32)
    lo, hi = x.min(), x.max()
    x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    x = np.pad(x, [(0, max(0, s - d)) for d, s in zip(x.shape, size)])
    return x[..., None]


@torch.no_grad()
def frame_logits(model: ref.ConvUNetR, video: np.ndarray, frames: Sequence[int], size: Sequence[int],
                 device: torch.device, block: int) -> torch.Tensor:
    """(len(frames), x, y, z, classes) float32 logits of the reference ``model`` (in eval mode)."""
    out = []
    with float32_products():
        for lo in range(0, len(frames), block):
            chunk = np.stack([frame_input(video, f, size) for f in frames[lo:lo + block]])
            logits = model(torch.from_numpy(chunk).to(device))
            out.append(logits[:, : video.shape[0], : video.shape[1], : video.shape[2]].float())
    return torch.cat(out)
