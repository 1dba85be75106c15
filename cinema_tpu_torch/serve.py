"""Serve SAX cine segmentation with a finetuned ConvUNetR
(port of examples/inference/segmentation_sax.py:47-81).

Each frame is min-max scaled to [0, 1] and end-padded to the model's patch
size, the frames run through the model in chunks of 8, the argmax labels
are cropped back to the input's shape.

Usage:
    python -m cinema_tpu_torch.serve --config config.yaml --model model.safetensors \
        --video cine.nii.gz --out labels.nii.gz [--device cuda]

``--video`` is a (x, y, z, t) cine and ``--out`` receives uint8 labels of the
same shape; each picks its format by its suffix: ``.nii`` or ``.nii.gz``
(NIfTI-1, the output keeping the input's voxel spacing) or ``.npy``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from cinema_tpu_torch import trace
from cinema_tpu_torch.data.nifti import load_nifti, save_nifti
from cinema_tpu_torch.data.transforms import scale_intensity, spatial_pad
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.inference import video_forward
from cinema_tpu_torch.models.convunetr import ConvUNetR
from cinema_tpu_torch.ops.window import crop_start

CHUNK = 8


def preprocess(video: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    """(x, y, z, t) cine -> (t, *patch-padded spatial, 1) float32 frames."""
    return np.stack(
        [spatial_pad(scale_intensity(video[..., t])[..., None], patch_size) for t in range(video.shape[-1])]
    )


@torch.no_grad()
def segment_cine(model: ConvUNetR, video: np.ndarray, chunk: int = CHUNK) -> np.ndarray:
    """Segment every frame of a (x, y, z, t) SAX cine; returns (x, y, z, t) uint8 labels.

    Counts the call in ``serve.studies``, its frames in ``serve.frames`` and the frames the model ran,
    the ragged last chunk's repeats included, in ``serve.frame_slots``; traced as ``serve.study``
    (request: the call's ordinal) and its phases (:mod:`cinema_tpu_torch.trace`)."""
    n_frames = video.shape[-1]
    trace.count("serve.studies")
    trace.count("serve.frames", n_frames)
    trace.count("serve.frame_slots", -(-n_frames // chunk) * chunk)
    device = next(model.parameters()).device
    with trace.span("serve.study", request=trace.counter("serve.studies")):
        with trace.span("serve.preprocess"):
            frames = preprocess(video, model.image_size_dict["sax"])
        with trace.span("serve.upload"):
            frames = torch.from_numpy(frames).to(device)
        with trace.span("serve.forward"):
            labels = video_forward(lambda x: model.predict_labels({"sax": x})["sax"], frames, chunk)
        with trace.span("serve.readback"):
            labels = labels.cpu()
        with trace.span("serve.crop"):
            labels = np.moveaxis(crop_start(labels.numpy(), (n_frames, *video.shape[:3])), 0, -1)
    return labels


def _is_nifti(path: Path) -> bool:
    return path.name.endswith((".nii", ".nii.gz"))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, type=Path, help="config.yaml of the finetuned model")
    parser.add_argument("--model", required=True, type=Path, help="safetensors weights")
    parser.add_argument("--video", required=True, type=Path, help="(x, y, z, t) SAX cine: .nii, .nii.gz or .npy")
    parser.add_argument("--out", required=True, type=Path, help="uint8 labels: .nii, .nii.gz or .npy")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dtype = torch.bfloat16 if torch.device(args.device).type == "cuda" else torch.float32
    model = from_finetuned("convunetr", args.model, args.config, dtype=dtype, device=args.device)
    if _is_nifti(args.video):
        video, header = load_nifti(args.video)
        spacing = header.spacing
    else:
        video, spacing = np.load(args.video), None
    labels = segment_cine(model, video)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    if _is_nifti(args.out):
        save_nifti(args.out, labels, spacing=spacing)
    else:
        np.save(args.out, labels)
    print(f"Saved labels {labels.shape} to {args.out}.")


if __name__ == "__main__":
    main()
