"""Landmark localization by coordinate regression (port of examples/inference/landmark_coordinate.py).

Loads a finetuned ConvViT from local safetensors weights and their config.yaml, reads a PNG (gray or colour,
as ``data.read_png_gray`` converts it), and prints the three predicted landmarks, scaled by the image's
width and height and truncated to integers, as (x, y); ``main`` returns the (3, 2) coordinates.

Usage:
    python -m cinema_tpu_torch.examples.inference.landmark_coordinate --model convvit.safetensors \
        --config config.yaml --image lax_2c.png [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser
from cinema_tpu_torch.examples.inference.landmark_heatmap import png_input
from cinema_tpu_torch.factory import from_finetuned


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    parser = example_parser(__doc__)
    parser.add_argument("--image", required=True, type=Path, help="PNG image")
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = from_finetuned("convvit", args.model, args.config, dtype=compute_dtype(args.device), device=args.device)
    view = model.views[0]
    image, (w, h) = png_input(args.image, model.image_size_dict[view])
    with torch.no_grad():
        out = model({view: torch.from_numpy(image).to(next(model.parameters()).device)})
    coords = (out.float().cpu().numpy()[0].reshape(3, 2) * np.array([w, h])).astype(int)
    print("landmark coordinates (x, y):")
    for i, (x, y) in enumerate(coords):
        print(f"  landmark {i}: ({x}, {y})")
    return coords


if __name__ == "__main__":
    main()
