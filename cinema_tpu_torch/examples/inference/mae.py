"""Masked-autoencoder reconstruction of a study (port of examples/inference/mae.py).

Loads a pretrained CineMA from local safetensors weights and their config.yaml, takes frame 0 of each view of
a study (``<study_dir>/<pid>_<view>_t.nii.gz``, ``pid`` the folder's name), masks ``--mask_ratio`` of the
patches with masks drawn from a ``torch.Generator`` seeded 0 (the JAX script draws them from
``PRNGKey(0)``: the two generators give other masks), and writes per view ``recon_<view>.npy``, the image
with the predicted masked patches put back, and for SAX the grid of original, masked, reconstructed and
error (``mae_reconstruction.png``); prints the loss.

Usage:
    python -m cinema_tpu_torch.examples.inference.mae --model cinema.safetensors --config config.yaml \
        --study_dir path/to/pid [--mask_ratio 0.75] [--out out/] [--device cuda]
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cinema_tpu_torch.data.nifti import load_nifti_frame
from cinema_tpu_torch.examples.common import check_local, compute_dtype, example_parser, preprocess
from cinema_tpu_torch.factory import mae_from_pretrained
from cinema_tpu_torch.models.mae import CineMA
from cinema_tpu_torch.ops.masking import PatchMask
from cinema_tpu_torch.ops.patch import patchify, unpatchify
from cinema_tpu_torch.viz import plot_mae_reconstruction


def study_images(model: CineMA, study_dir: Path, frame: int = 0) -> Dict[str, np.ndarray]:
    """Per view of the model the (1, *patch, 1) float32 input of frame ``frame`` of the study, scaled and
    end-padded; a LAX view's single slice."""
    pid = study_dir.name
    images = {}
    for view in model.views:
        image, _ = load_nifti_frame(study_dir / f"{pid}_{view}_t.nii.gz", frame)
        if view != "sax":
            image = image[:, :, 0]
        images[view] = preprocess(image.astype(np.float32)[..., None], model.image_size_dict[view])[None]
    return images


def scatter_patches(model: CineMA, view: str, image: torch.Tensor, values: torch.Tensor,
                    mask_ids: torch.Tensor) -> np.ndarray:
    """The (x, y[, z]) float32 image with its masked patches (``mask_ids`` of batch item 0) replaced by
    ``values`` (n_masked, patch volume)."""
    dec_patch = model.dec_patch_size_dict[view]
    grid = tuple(s // p for s, p in zip(model.image_size_dict[view], dec_patch))
    full = patchify(image, dec_patch).float().clone()  # patchify may return a view of the input
    full[0, mask_ids[0]] = values.float()
    return unpatchify(full, dec_patch, grid)[0, ..., 0].cpu().numpy()


@torch.no_grad()
def reconstruct(model: CineMA, images: Dict[str, np.ndarray], mask_ratio: float,
                mask_dict: Optional[Dict[str, PatchMask]] = None, generator: Optional[torch.Generator] = None):
    """The MAE forward of a study and what it shows: (loss, per-view predictions, masks, per-view
    reconstructions (x, y[, z]), per-view mask volumes, 1 where a patch was masked). The masks are
    ``mask_dict`` where given, else drawn from ``generator``."""
    device = next(model.parameters()).device
    tensors = {v: torch.from_numpy(x).to(device) for v, x in images.items()}
    loss, preds, masks, _ = model(tensors, mask_ratio, mask_dict, generator=generator)
    recons, mask_vols = {}, {}
    for view, image in tensors.items():
        ids = masks[view].mask_ids
        recons[view] = scatter_patches(model, view, image, preds[view][0], ids)
        ones = torch.ones((ids.shape[1], preds[view].shape[-1]), device=device)
        mask_vols[view] = scatter_patches(model, view, torch.zeros_like(image), ones, ids)
    return loss, preds, masks, recons, mask_vols


def main(argv: Optional[List[str]] = None) -> Sequence:
    parser = example_parser(__doc__)
    parser.add_argument("--study_dir", required=True, type=Path, help="pid folder with <pid>_<view>_t.nii.gz")
    parser.add_argument("--mask_ratio", type=float, default=0.75)
    parser.add_argument("--out", type=Path, default=Path("out"))
    args = parser.parse_args(argv)
    check_local(args.model, args.config)

    model = mae_from_pretrained(args.model, args.config, dtype=compute_dtype(args.device), device=args.device)
    images = study_images(model, args.study_dir)
    generator = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
    result = reconstruct(model, images, args.mask_ratio, generator=generator)
    loss, _, _, recons, mask_vols = result
    args.out.mkdir(parents=True, exist_ok=True)
    for view in model.views:
        np.save(args.out / f"recon_{view}.npy", recons[view])
    if "sax" in recons:
        plot_mae_reconstruction(images["sax"][0, ..., 0], recons["sax"], mask_vols["sax"],
                                args.out / "mae_reconstruction.png")
    print(f"loss={float(loss):.4f}; reconstructions saved to {args.out}")
    return result


if __name__ == "__main__":
    main()
