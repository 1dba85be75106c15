"""SAX ventricle and myocardium segmentation of a cine (port of examples/inference/segmentation_sax.py).

Loads a finetuned ConvUNetR from local safetensors weights and their config.yaml, segments every frame of a
4-D SAX NIfTI (``serve.segment_cine``: chunks of 8 frames, the last filled by repeating the first), and
writes the labels as NIfTI with the input's spacing, the animated cine GIF and the volume curves (PNG), and
prints the LVEF and RVEF.

Usage:
    python -m cinema_tpu_torch.examples.inference.segmentation_sax --model convunetr_sax.safetensors \
        --config config.yaml --image patient_sax_t.nii.gz --out out/ [--t_step 1] [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.serve import segment_cine
from cinema_tpu_torch.viz import plot_segmentations_gif, plot_volume_changes


def main(argv: Optional[List[str]] = None) -> None:
    parser = example_parser(__doc__)
    parser.add_argument("--image", required=True, type=Path, help="4D SAX NIfTI (x, y, z, t)")
    parser.add_argument("--out", type=Path, default=Path("out"))
    parser.add_argument("--t_step", type=int, default=1, help="GIF temporal stride")
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = from_finetuned("convunetr", args.model, args.config, dtype=compute_dtype(args.device),
                           device=args.device)
    video, header = load_nifti(args.image)  # (x, y, z, t)
    n_frames = video.shape[-1]
    labels = segment_cine(model, video)  # (x, y, z, t) uint8

    args.out.mkdir(parents=True, exist_ok=True)
    save_nifti(args.out / "segmentation_sax_t.nii.gz", labels, spacing=header.spacing)
    plot_segmentations_gif(video.astype(np.float32), labels, args.out / "segmentation_sax.gif", t_step=args.t_step)
    ml_per_voxel = float(np.prod(header.spacing[:3])) / 1000.0
    efs = plot_volume_changes(labels, args.out / "ventricle_volumes.png", t_step=args.t_step,
                              ml_per_voxel=ml_per_voxel)
    print(f"LVEF = {efs['lvef']:.2f}%, RVEF = {efs['rvef']:.2f}%")
    print(f"Saved segmentation for {n_frames} frames to {args.out}.")


if __name__ == "__main__":
    main()
