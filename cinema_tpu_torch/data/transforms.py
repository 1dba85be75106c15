"""Host-side augmentation of the fine-tuning and pretraining items (port of cinema_tpu/data/transforms.py;
the MONAI subset of the reference, cinema/segmentation/dataset.py:140-220 and mae/pretrain.py:157-200).

- Arrays are channels-last numpy: an image (x, y[, z], ch), a label (x, y[, z]).
- Every transform is a callable ``(data, rng) -> data`` that draws from the explicit
  ``np.random.Generator`` it is given, in the JAX package's order: for the same generator
  each gives the JAX package's output bit for bit, so a port run replays a JAX run's
  augmentations.
- A geometric transform applies the parameters it draws for an ``*_image`` key to the
  matching ``*_label`` key too (linear interpolation for the image, nearest for the label).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage

Data = Dict[str, np.ndarray]
Keys = Union[str, Sequence[str]]


def _as_keys(keys: Keys) -> Tuple[str, ...]:
    return (keys,) if isinstance(keys, str) else tuple(keys)


def scale_intensity(x: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1] as float32; a constant array becomes zeros."""
    x = x.astype(np.float32)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def spatial_pad(x: np.ndarray, spatial_size: Sequence[int], channel: bool = True) -> np.ndarray:
    """End-pad the spatial axes of ``x`` with zeros to at least ``spatial_size``: all but the last axis
    of a channels-last ``x``, every axis otherwise."""
    spatial = x.shape[:-1] if channel else x.shape
    pads = [(0, max(0, t - s)) for s, t in zip(spatial, spatial_size)]
    if channel:
        pads.append((0, 0))
    return np.pad(x, pads)


class Compose:
    """The transforms in order, drawing from one generator."""

    def __init__(self, transforms: Sequence) -> None:
        self.transforms = list(transforms)

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        for t in self.transforms:
            data = t(data, rng)
        return data


class ScaleIntensityd:
    """Min-max rescale to [0, 1] (MONAI ScaleIntensityd defaults)."""

    def __init__(self, keys: Keys) -> None:
        self.keys = _as_keys(keys)

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        for key in self.keys:
            if key in data:
                data[key] = scale_intensity(data[key])
        return data


class SpatialPadd:
    """End-pad the spatial axes to at least ``spatial_size`` (MONAI method='end'): an array with one
    axis more than ``spatial_size`` is channels-last, unless ``has_channel`` says otherwise by key."""

    def __init__(self, keys: Keys, spatial_size: Sequence[int], has_channel: Optional[Dict[str, bool]] = None) -> None:
        self.keys = _as_keys(keys)
        self.spatial_size = tuple(spatial_size)
        self.has_channel = has_channel or {}

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        for key in self.keys:
            if key in data:
                x = data[key]
                channel = self.has_channel.get(key, x.ndim == len(self.spatial_size) + 1)
                data[key] = spatial_pad(x, self.spatial_size, channel)
        return data


class RandAdjustContrastd:
    """Random gamma of the min-max normalised intensities (MONAI RandAdjustContrastd)."""

    def __init__(self, keys: Keys, prob: float, gamma: Tuple[float, float]) -> None:
        self.keys = _as_keys(keys)
        self.prob = prob
        self.gamma = tuple(gamma)

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        if rng.uniform() >= self.prob:
            return data
        gamma = rng.uniform(self.gamma[0], self.gamma[1])
        for key in self.keys:
            if key in data:
                x = data[key].astype(np.float32)
                lo = x.min()
                span = x.max() - lo + 1e-7
                data[key] = ((x - lo) / span) ** gamma * span + lo
        return data


class RandGaussianNoised:
    """Additive Gaussian noise (MONAI RandGaussianNoised, std 0.1 by default)."""

    def __init__(self, keys: Keys, prob: float, mean: float = 0.0, std: float = 0.1) -> None:
        self.keys = _as_keys(keys)
        self.prob = prob
        self.mean = mean
        self.std = std

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        if rng.uniform() >= self.prob:
            return data
        for key in self.keys:
            if key in data:
                x = data[key].astype(np.float32)
                data[key] = x + rng.normal(self.mean, self.std, size=x.shape).astype(np.float32)
        return data


def _rotation_matrix(nd: int, angles: Sequence[float]) -> np.ndarray:
    """The rotation by one angle in 2-D, or by three (about x, then y, then z: ``mx @ my @ mz``) in 3-D."""
    if nd == 2:
        c, s = math.cos(angles[0]), math.sin(angles[0])
        return np.array([[c, -s], [s, c]])
    rx, ry, rz = (list(angles) + [0.0, 0.0, 0.0])[:3]
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mx @ my @ mz


class RandAffined:
    """Random rotation, translation and scaling about the image centre, zero outside (MONAI RandAffined
    with mode=('bilinear', 'nearest')): the same drawn parameters for the image and the label keys."""

    def __init__(
        self,
        image_keys: Keys,
        label_keys: Keys = (),
        prob: float = 0.5,
        rotate_range: Sequence[float] = (),
        translate_range: Sequence[float] = (),
        scale_range: float = 0.0,
    ) -> None:
        self.image_keys = _as_keys(image_keys)
        self.label_keys = _as_keys(label_keys) if label_keys else ()
        self.prob = prob
        self.rotate_range = [r / 180.0 * math.pi for r in rotate_range]
        self.translate_range = list(translate_range)
        self.scale_range = scale_range

    @staticmethod
    def _apply(x: np.ndarray, matrix: np.ndarray, offset: np.ndarray, order: int) -> np.ndarray:
        def warp(a: np.ndarray) -> np.ndarray:
            return ndimage.affine_transform(a, matrix, offset=offset, order=order, mode="constant", cval=0.0)

        if x.ndim == matrix.shape[0] + 1:  # channels-last
            return np.stack([warp(x[..., c]) for c in range(x.shape[-1])], axis=-1).astype(x.dtype)
        return warp(x).astype(x.dtype)

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        if rng.uniform() >= self.prob:
            return data
        ref_key = next((k for k in self.image_keys if k in data), None)
        if ref_key is None:
            return data
        x = data[ref_key]
        nd = len(self.translate_range) if self.translate_range else (x.ndim - 1)
        spatial = np.array(x.shape[:nd], dtype=np.float64)

        angles = [rng.uniform(-r, r) for r in self.rotate_range]
        translation = np.array([rng.uniform(-t, t) for t in self.translate_range] if self.translate_range
                               else [0.0] * nd)
        scale = 1.0 + rng.uniform(-self.scale_range, self.scale_range) if self.scale_range else 1.0

        matrix = (_rotation_matrix(nd, angles) if angles else np.eye(nd)) * scale
        # output coordinate o reads input coordinate matrix @ (o - c) + c - t
        center = (spatial - 1) / 2.0
        offset = center - matrix @ center - translation
        for key in self.image_keys:
            if key in data:
                data[key] = self._apply(data[key].astype(np.float32), matrix, offset, order=1)
        for key in self.label_keys:
            if key in data:
                data[key] = self._apply(data[key], matrix, offset, order=0)
        return data


class RandCoarseDropoutd:
    """Zero ``holes`` random boxes of ``spatial_size`` (MONAI RandCoarseDropoutd)."""

    def __init__(self, keys: Keys, prob: float, spatial_size: Sequence[int], holes: int = 1,
                 fill_value: float = 0.0) -> None:
        self.keys = _as_keys(keys)
        self.prob = prob
        self.spatial_size = tuple(spatial_size)
        self.holes = holes
        self.fill_value = fill_value

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        if rng.uniform() >= self.prob:
            return data
        ref_key = next((k for k in self.keys if k in data), None)
        if ref_key is None:
            return data
        spatial = data[ref_key].shape[: len(self.spatial_size)]
        for _ in range(self.holes):
            starts = [int(rng.integers(0, max(1, s - h + 1))) for s, h in zip(spatial, self.spatial_size)]
            box = tuple(slice(st, st + h) for st, h in zip(starts, self.spatial_size))
            for key in self.keys:
                if key in data:
                    data[key] = data[key].copy()
                    data[key][box] = self.fill_value
        return data


class RandSpatialCropd:
    """A random crop of ``roi_size`` (MONAI RandSpatialCropd, random_size=False), the same for every key;
    an axis no longer than the crop is kept whole."""

    def __init__(self, keys: Keys, roi_size: Sequence[int], has_channel: Optional[Dict[str, bool]] = None) -> None:
        self.keys = _as_keys(keys)
        self.roi_size = tuple(roi_size)
        self.has_channel = has_channel or {}

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        ref_key = next((k for k in self.keys if k in data), None)
        if ref_key is None:
            return data
        x = data[ref_key]
        channel = self.has_channel.get(ref_key, x.ndim == len(self.roi_size) + 1)
        spatial = x.shape[:-1] if channel else x.shape
        starts = [int(rng.integers(0, s - r + 1)) if s > r else 0 for s, r in zip(spatial, self.roi_size)]
        box = tuple(slice(st, st + min(r, s)) for st, r, s in zip(starts, self.roi_size, spatial))
        for key in self.keys:
            if key in data:
                y = data[key]
                ch = self.has_channel.get(key, y.ndim == len(self.roi_size) + 1)
                data[key] = y[box + (slice(None),)] if ch else y[box]
        return data


class RandZoomd:
    """A random zoom that keeps the size (MONAI RandZoomd, keep_size=True): one zoom factor for every key,
    each channel zoomed by ``ndimage.zoom``, then centre-cropped or zero-padded back to the input's size."""

    def __init__(self, keys: Keys, prob: float, min_zoom: float = 0.9, max_zoom: float = 1.1,
                 order: int = 1) -> None:
        self.keys = _as_keys(keys)
        self.prob = prob
        self.min_zoom = min_zoom
        self.max_zoom = max_zoom
        self.order = order

    def __call__(self, data: Data, rng: np.random.Generator) -> Data:
        if rng.uniform() >= self.prob:
            return data
        zoom = rng.uniform(self.min_zoom, self.max_zoom)
        for key in self.keys:
            if key not in data:
                continue
            x = data[key].astype(np.float32)
            nd = x.ndim - 1  # channels-last
            zoomed = np.stack([ndimage.zoom(x[..., c], zoom, order=self.order) for c in range(x.shape[-1])],
                              axis=-1)
            out = np.zeros_like(x)
            src, dst = [], []
            for s, z in zip(x.shape[:nd], zoomed.shape[:nd]):
                if z >= s:  # crop the centre; an odd excess leaves the extra voxel at the end
                    start = (z - s) // 2
                    src.append(slice(start, start + s))
                    dst.append(slice(0, s))
                else:  # pad around the centre; an odd deficit leaves the extra zero at the end
                    start = (s - z) // 2
                    src.append(slice(0, z))
                    dst.append(slice(start, start + z))
            out[tuple(dst) + (slice(None),)] = zoomed[tuple(src) + (slice(None),)]
            data[key] = out
        return data


def get_segmentation_transforms(config) -> Tuple[Compose, Compose]:
    """The (train, val) pipelines of the fine-tuning tasks, per view of ``config.model.views``
    (reference segmentation/dataset.py:140-220).

    Train: contrast, noise, min-max scaling, a random affine, coarse dropout where the view's
    ``transform`` section gives ``dropout_size``, a random crop to the view's patch size and an
    end-pad up to it. Val: min-max scaling and the end-pad.
    """
    views = [config.model.views] if isinstance(config.model.views, str) else list(config.model.views)

    def view_cfg(section, v):
        return section.sax if v == "sax" else section.lax

    train, val = [], []
    for view in views:
        image, label = f"{view}_image", f"{view}_label"
        patch_size = tuple(view_cfg(config.data, view).patch_size)
        tcfg = view_cfg(config.transform, view)
        train += [
            RandAdjustContrastd(image, config.transform.prob, tuple(config.transform.gamma)),
            # the reference's order: noise (std 0.1) before min-max scaling
            RandGaussianNoised(image, config.transform.prob),
            ScaleIntensityd(image),
            RandAffined(image_keys=image, label_keys=label, prob=config.transform.prob,
                        rotate_range=list(tcfg.rotate_range), translate_range=list(tcfg.translate_range),
                        scale_range=config.transform.scale_range),
        ]
        if tcfg.get("dropout_size"):
            train.append(RandCoarseDropoutd(image, config.transform.prob, tuple(tcfg.dropout_size)))
        train += [RandSpatialCropd((image, label), patch_size), SpatialPadd((image, label), patch_size)]
        val += [ScaleIntensityd(image), SpatialPadd((image, label), patch_size)]
    return Compose(train), Compose(val)


def get_pretrain_transforms(config) -> Compose:
    """The MAE pretraining pipeline (reference mae/pretrain.py:157-200): a random zoom of the ``sax`` frame
    and one shared by the three ``lax_*`` frames, min-max scaling, and an end-pad up to the views' patch
    sizes. A frame larger than its patch is padded by nothing and never cropped, as in the JAX package."""
    scale = config.transform.scale_range
    lax = ("lax_2c", "lax_3c", "lax_4c")
    return Compose([
        RandZoomd("sax", config.transform.prob, 1 - scale, 1 + scale),
        RandZoomd(lax, config.transform.prob, 1 - scale, 1 + scale),
        ScaleIntensityd(("sax", *lax)),
        SpatialPadd("sax", tuple(config.data.sax.patch_size)),
        SpatialPadd(lax, tuple(config.data.lax.patch_size)),
    ])
