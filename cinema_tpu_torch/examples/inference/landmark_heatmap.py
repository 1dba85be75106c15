"""Landmark localization by heatmaps (port of examples/inference/landmark_heatmap.py).

Loads a finetuned ConvUNetR from local safetensors weights and their config.yaml, reads a PNG (gray or
colour, as ``data.read_png_gray`` converts it), and prints the argmax of each of the three heatmaps, cropped
back to the image, as (x, y); ``main`` returns the (3, 2) coordinates.

Usage:
    python -m cinema_tpu_torch.examples.inference.landmark_heatmap --model convunetr.safetensors \
        --config config.yaml --image lax_2c.png [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.data.datasets import read_png_gray
from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser, preprocess
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.metrics import heatmap_argmax
from cinema_tpu_torch.ops.window import crop_start


def png_input(path: Path, patch_size) -> tuple:
    """((1, *padded (x, y), 1) float32 input, (w, h)) of a PNG, scaled and end-padded."""
    image = read_png_gray(path)
    return preprocess(image[..., None], patch_size)[None], image.shape


@torch.no_grad()
def heatmap_logits(model: nn.Module, image: np.ndarray, size: tuple) -> torch.Tensor:
    """The (1, w, h, 3) heatmap logits of the first view, cropped back to the image's size."""
    view = model.views[0]
    out = model({view: torch.from_numpy(image).to(next(model.parameters()).device)})[view]
    return crop_start(out, (1, *size, 3))


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    parser = example_parser(__doc__)
    parser.add_argument("--image", required=True, type=Path, help="PNG image")
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = from_finetuned("convunetr", args.model, args.config, dtype=compute_dtype(args.device),
                           device=args.device)
    image, size = png_input(args.image, model.image_size_dict[model.views[0]])
    coords = heatmap_argmax(heatmap_logits(model, image, size)).cpu().numpy()[0].reshape(3, 2)
    print("landmark coordinates (x, y):")
    for i, (x, y) in enumerate(coords):
        print(f"  landmark {i}: ({int(x)}, {int(y)})")
    return coords


if __name__ == "__main__":
    main()
