"""The body of the six ED/ES inference scripts (``classification_{cvd,sex,vendor}``,
``regression_{age,bmi,ef}``; port of examples/inference/classification_cvd.py and its five twins).

A finetuned ConvViT from local safetensors weights and their config.yaml takes the ED and ES frames of a
study as two channels, min-max scaled and end-padded to the patch size. Where a frame is deeper than the
patch, its half-overlapping patches go through ``classification_forward`` (the mean of their softmax) or
``regression_forward`` (the mean of their outputs).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from cinema_tpu_torch.data.nifti import load_nifti
from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser, preprocess
from cinema_tpu_torch.factory import from_finetuned
from cinema_tpu_torch.tasks.classification import classification_forward
from cinema_tpu_torch.tasks.regression import regression_forward


def edes_image(ed_path: Path, es_path: Path, patch_size: Sequence[int]) -> np.ndarray:
    """The (1, *padded, 2) float32 input of a study: ED and ES as channels, scaled together, padded."""
    ed, _ = load_nifti(ed_path)
    es, _ = load_nifti(es_path)
    return preprocess(np.stack([ed, es], axis=-1).astype(np.float32), patch_size)[None]


@torch.no_grad()
def edes_forward(model: nn.Module, task: str, image: np.ndarray) -> np.ndarray:
    """Classification: the (n_classes,) float32 probabilities; regression: the (1,) normalised prediction."""
    view = model.views[0]
    images = {view: torch.from_numpy(image).to(next(model.parameters()).device)}
    patch_size = {view: tuple(model.image_size_dict[view])}
    if task == "classification":
        return torch.softmax(classification_forward(model, images, patch_size).float(), dim=-1)[0].cpu().numpy()
    return regression_forward(model, images, patch_size).float()[0].cpu().numpy()


def edes_main(task: str, doc: str, argv: Optional[List[str]] = None) -> Union[np.ndarray, float]:
    """Parse the arguments, run the model on the study and print the JAX script's lines; returns the class
    probabilities (classification) or the normalised prediction (regression)."""
    parser = example_parser(doc)
    parser.add_argument("--ed", required=True, type=Path, help="ED frame NIfTI")
    parser.add_argument("--es", required=True, type=Path, help="ES frame NIfTI")
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = from_finetuned("convvit", args.model, args.config, dtype=compute_dtype(args.device), device=args.device)
    view = model.views[0]
    out = edes_forward(model, task, edes_image(args.ed, args.es, model.image_size_dict[view]))
    if task == "classification":
        print("class probabilities:", np.round(out, 4))
        print("predicted class index:", int(np.argmax(out)))
        return out
    pred = float(out[0])
    print(f"normalised prediction: {pred:.4f}")
    print("multiply by the task std and add the mean from the config to denormalise")
    return pred
