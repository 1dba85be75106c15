"""The traffic generator: batches and studies made from ``--seed`` by the parameters of a workload file.

Images are noise with a bright disc, as the UKB preprocessing's synthetic studies of the repository's
chip smoke test are written (uint8 noise plus 150 inside the disc; here the noise's amplitude varies
from image to image, ``NOISE``); the training pools
are min-max scaled to [0, 1] as the loaders deliver them, and segmentation labels are the disc's
bands (1 inside 0.6 r, 2 up to r, 3 up to 1.3 r, 0 elsewhere). Shapes that vary between items come
from the workload file's own ``shape_seed``, so every ``--seed`` makes the same sizes in the same
order, with other voxels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# the noise of an image is uniform in [0, a) with a drawn per image from this range, so that images of
# one batch differ in their signal-to-noise ratio as scans do
NOISE = (20, 100)


def _discs(gen: torch.Generator, n: int, spatial, device) -> torch.Tensor:
    """(n, *spatial) float images in [0, 1]: noise with a disc of seeded centre and radius in the
    first two axes, the same through the others; and the disc's normalised radius per voxel."""
    amplitude = torch.randint(NOISE[0], NOISE[1] + 1, (n,), generator=gen, device=device).float()
    noise = torch.floor(torch.rand((n, *spatial), generator=gen, device=device) * amplitude.reshape(n, *([1] * len(spatial))))
    centre = torch.rand((n, 2), generator=gen, device=device) * 0.3 + 0.35
    radius = torch.rand((n,), generator=gen, device=device) * 0.08 + 0.1
    gx = torch.arange(spatial[0], device=device).float() / spatial[0]
    gy = torch.arange(spatial[1], device=device).float() / spatial[1]
    d2 = (gx[None, :, None] - centre[:, 0, None, None]) ** 2 + (gy[None, None, :] - centre[:, 1, None, None]) ** 2
    rel = (d2.sqrt() / radius[:, None, None]).reshape(n, spatial[0], spatial[1], *([1] * (len(spatial) - 2)))
    rel = rel.expand(n, *spatial)
    image = noise + 150.0 * (rel < 1.0).float()
    lo = image.flatten(1).amin(1).reshape(n, *([1] * len(spatial)))
    hi = image.flatten(1).amax(1).reshape(n, *([1] * len(spatial)))
    return (image - lo) / (hi - lo), rel


def image_pool(traffic: dict, cfg: dict, seed: int, device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["n_batches"]`` distinct batches of ``traffic["batch"]`` rows, resident on ``device``.

    ``traffic["inputs"]`` is ``"mae_views"`` (an image per view of the MAE configuration, keyed by
    view) or ``"sax_labels"`` (``sax_image`` and its 4-class ``sax_label``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    n, b = int(traffic["n_batches"]), int(traffic["batch"])
    pool: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    if traffic["inputs"] == "mae_views":
        for view in cfg["model"]["views"]:
            size = cfg["data"]["sax" if view == "sax" else "lax"]["patch_size"]
            images, _ = _discs(gen, n * b, size, device)
            for i in range(n):
                pool[i][view] = images[i * b:(i + 1) * b, ..., None].contiguous()
    elif traffic["inputs"] == "sax_labels":
        size = cfg["data"]["sax"]["patch_size"]
        images, rel = _discs(gen, n * b, size, device)
        labels = torch.zeros(rel.shape, dtype=torch.uint8, device=device)
        for cls, bound in ((3, 1.3), (2, 1.0), (1, 0.6)):
            labels[rel < bound] = cls
        for i in range(n):
            pool[i]["sax_image"] = images[i * b:(i + 1) * b, ..., None].contiguous()
            pool[i]["sax_label"] = labels[i * b:(i + 1) * b].contiguous()
    else:
        raise ValueError(f"Unknown inputs {traffic['inputs']!r}.")
    return pool


def study_shapes(traffic: dict) -> List[tuple]:
    """The (x, y, z, t) of every study of the mix in the order they are served, drawn from the workload's
    ``shape_seed``: a share ``long_share`` with t = ``long_t`` and the rest with t in ``short_t``, long
    and short in turn, so that a window served the two kinds in the same proportion whatever study it
    ends on. Every ``--seed`` serves this sequence; the seed makes the voxels."""
    rng = np.random.default_rng(int(traffic["shape_seed"]))
    n = int(traffic["n_studies"])
    n_long = round(n * float(traffic["long_share"]))
    shapes = []
    for i in range(n):
        x, y = (int(rng.integers(lo, hi + 1)) for lo, hi in (traffic["x"], traffic["y"]))
        z = int(rng.integers(traffic["z"][0], traffic["z"][1] + 1))
        t = int(traffic["long_t"]) if i < n_long else int(rng.integers(traffic["short_t"][0], traffic["short_t"][1] + 1))
        shapes.append((x, y, z, t))
    longs, shorts = shapes[:n_long], shapes[n_long:]
    return [s for pair in zip(longs, shorts) for s in pair] + longs[len(shorts):] + shorts[len(longs):]


def cine_studies(traffic: dict, seed: int) -> List[np.ndarray]:
    """The mix's studies (:func:`study_shapes`): uint8 (x, y, z, t) cines, noise with a disc of 150
    whose radius follows the frame, made from ``seed`` in host memory."""
    shapes = study_shapes(traffic)
    studies = []
    for k, (x, y, z, t) in enumerate(shapes):
        rng = np.random.default_rng([int(seed) % (2**63), 2, k])
        video = rng.integers(0, rng.integers(NOISE[0], NOISE[1] + 1), (x, y, z, t), dtype=np.uint8)
        gx, gy = np.ogrid[:x, :y]
        cx, cy = rng.uniform(0.35, 0.65, 2) * (x, y)
        r2 = (gx - cx) ** 2 + (gy - cy) ** 2
        for f in range(t):
            radius = 18 + 6 * np.sin(2 * np.pi * f / t)
            video[r2 < radius**2, :, f] += 150
        studies.append(video)
    return studies
