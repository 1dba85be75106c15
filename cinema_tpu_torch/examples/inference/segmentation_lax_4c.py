"""LAX 4-chamber segmentation of a cine (port of examples/inference/segmentation_lax_4c.py).

Loads a finetuned ConvUNetR from local safetensors weights and their config.yaml, segments every frame of a
4-D LAX NIfTI (x, y, 1, t) in one forward, and writes the labels (x, y, 1, t) as NIfTI with the input's
spacing, the animated cine GIF and the area curves (PNG).

Usage:
    python -m cinema_tpu_torch.examples.inference.segmentation_lax_4c --model convunetr_lax_4c.safetensors \
        --config config.yaml --image patient_lax_4c_t.nii.gz --out out/ [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser, preprocess
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.models.convunetr import ConvUNetR
from cinema_tpu_torch.ops.window import crop_start
from cinema_tpu_torch.viz import plot_segmentations_gif, plot_volume_changes

VIEW = "lax_4c"


def preprocess_frames(video: np.ndarray, patch_size) -> np.ndarray:
    """(x, y, 1, t) cine -> (t, *patch-padded (x, y), 1) float32 frames, each scaled on its own."""
    return np.stack([preprocess(video[:, :, 0, t][..., None], patch_size) for t in range(video.shape[-1])])


@torch.no_grad()
def segment_lax(model: ConvUNetR, video: np.ndarray) -> tuple:
    """(logits (t, *patch, n_classes) on the model's device, labels (x, y, 1, t) uint8) of every frame of a
    (x, y, 1, t) cine, all frames in one forward."""
    device = next(model.parameters()).device
    frames = torch.from_numpy(preprocess_frames(video, model.image_size_dict[VIEW])).to(device)
    logits = model({VIEW: frames})[VIEW]
    labels = crop_start(logits.argmax(dim=-1).to(torch.uint8).cpu().numpy(), (video.shape[-1], *video.shape[:2]))
    return logits, np.moveaxis(labels, 0, -1)[:, :, None, :]


def main(argv: Optional[List[str]] = None) -> None:
    parser = example_parser(__doc__)
    parser.add_argument("--image", required=True, type=Path, help="4D LAX NIfTI (x, y, 1, t)")
    parser.add_argument("--out", type=Path, default=Path("out"))
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = from_finetuned("convunetr", args.model, args.config, dtype=compute_dtype(args.device),
                           device=args.device)
    video, header = load_nifti(args.image)  # (x, y, 1, t)
    _, labels = segment_lax(model, video)

    args.out.mkdir(parents=True, exist_ok=True)
    save_nifti(args.out / "segmentation_lax_4c_t.nii.gz", labels, spacing=header.spacing)
    plot_segmentations_gif(video.astype(np.float32), labels, args.out / "segmentation_lax_4c.gif")
    plot_volume_changes(labels, args.out / "lax_4c_areas.png")
    print(f"Saved segmentation for {video.shape[-1]} frames to {args.out}.")


if __name__ == "__main__":
    main()
