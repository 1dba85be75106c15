"""Feature extraction with a pretrained CineMA (port of examples/inference/mae_feature_extraction.py).

Loads a pretrained CineMA from local safetensors weights and their config.yaml, runs the unmasked encoder
(``feature_forward``) on frame ``--frame`` of each view of a study (``<study_dir>/<pid>_<view>_t.nii.gz``),
and writes the features to ``.npz`` under the JAX script's keys, ``cls`` (1, 1, E) and one (1, n_patches, E)
per view, as float32; ``main`` returns them.

Usage:
    python -m cinema_tpu_torch.examples.inference.mae_feature_extraction --model cinema.safetensors \
        --config config.yaml --study_dir path/to/pid [--frame 0] [--out out/features.npz] [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser
from cinema_tpu_torch.examples.inference.mae import study_images
from cinema_tpu_torch.factory import mae_from_pretrained


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    parser = example_parser(__doc__)
    parser.add_argument("--study_dir", required=True, type=Path, help="pid folder with <pid>_<view>_t.nii.gz")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--out", type=Path, default=Path("out/features.npz"))
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = mae_from_pretrained(args.model, args.config, dtype=compute_dtype(args.device), device=args.device)
    device = next(model.parameters()).device
    images = {v: torch.from_numpy(x).to(device) for v, x in study_images(model, args.study_dir, args.frame).items()}
    with torch.no_grad():
        feats = model.feature_forward(images)
    out = {k: v.float().cpu().numpy() for k, v in feats.items()}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **out)
    for k, v in out.items():
        print(f"{k}: {v.shape}")
    print(f"Saved features to {args.out}.")
    return out


if __name__ == "__main__":
    main()
