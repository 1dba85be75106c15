"""Image geometry and intensity toolkit of the preprocessing (port of cinema_tpu/data/geometry.py;
reference cinema/data/sitk.py).

Plane intersections for the LAX/SAX geometry, spacing resampling, the percentile clip and z-norm,
bounding-box crops and pads and the uint8 cast, in numpy and scipy. The calls and their order are the
JAX package's, so that the same inputs give the same arrays bit for bit. Host code: nothing here runs on
the card.

Arrays are ``arr[x, y, z]`` with per-axis ``spacing`` in mm, as in :mod:`cinema_tpu_torch.data.nifti`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)


def plane_plane_intersection(
    rot1: np.ndarray,
    origin1: np.ndarray,
    rot2: np.ndarray,
    origin2: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Intersection line of two oriented planes (reference sitk.py:21-84).

    Args:
        rot1/rot2: (3,3) direction matrices, third column = plane normal.
        origin1/origin2: (3,) plane origins.

    Returns:
        (line_point, line_vec).
    """
    n1 = rot1[:, -1] / np.linalg.norm(rot1[:, -1])
    n2 = rot2[:, -1] / np.linalg.norm(rot2[:, -1])
    line_vec = np.cross(n1, n2)
    line_vec = line_vec / np.linalg.norm(line_vec)
    a = np.array([n1, n2, line_vec])
    cond = np.linalg.cond(a)
    if cond > 1 / np.finfo(a.dtype).eps:
        logger.error(f"matrix a is ill-conditioned, np.linalg.cond(a)={cond}")
    b = np.array([np.dot(origin1, n1), np.dot(origin2, n2), 0.0])
    line_point = np.linalg.solve(a, b)
    return line_point, line_vec


def plane_line_intersection(
    rot: np.ndarray,
    origin: np.ndarray,
    line_point: np.ndarray,
    line_vec: np.ndarray,
    epsilon: float = 1e-6,
) -> Optional[np.ndarray]:
    """Intersection point of a plane and a line (reference sitk.py:86-139)."""
    n = rot[:, -1] / np.linalg.norm(rot[:, -1])
    denominator = np.dot(n, line_vec)
    if np.abs(denominator) < epsilon:
        logger.info(f"plane normal {n} is orthogonal to line_vec {line_vec}.")
        return None
    t = np.dot(n, origin - line_point) / denominator
    return line_point + t * line_vec


def resample_spacing(
    array: np.ndarray,
    spacing: Sequence[float],
    target_spacing: Sequence[float],
    is_label: bool = False,
) -> np.ndarray:
    """Resample to a new voxel spacing (reference sitk.py:171-244).

    Linear interpolation for images, nearest for labels; output size is
    round(size * spacing / target_spacing). 4D arrays resample frame-wise
    over the last axis with 3D spacing.

    Args:
        array: (x, y, z) or (x, y, z, t).
        spacing: current spacing (3,).
        target_spacing: desired spacing (3,).
        is_label: nearest-neighbour when True.

    Returns:
        resampled array.
    """
    spacing = np.asarray(spacing, dtype=np.float64)
    target = np.asarray(target_spacing, dtype=np.float64)
    zoom = spacing / target
    order = 0 if is_label else 1
    if array.ndim == len(spacing) + 1:
        frames = [
            ndimage.zoom(array[..., t], zoom, order=order, mode="nearest")
            for t in range(array.shape[-1])
        ]
        return np.stack(frames, axis=-1)
    if array.ndim != len(spacing):
        raise ValueError(f"Array rank {array.ndim} does not match spacing rank {len(spacing)}.")
    return ndimage.zoom(array, zoom, order=order, mode="nearest")


def clip_and_normalise_intensity(
    array: np.ndarray,
    intensity_range: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Percentile clip -> z-norm -> rescale to [0,1] (reference sitk.py:246-302).

    4D arrays are processed frame-wise over the last axis, matching the
    reference's process_4d wrapper.
    """
    if array.ndim == 4:
        return np.stack(
            [clip_and_normalise_intensity(array[..., t], intensity_range) for t in range(array.shape[-1])],
            axis=-1,
        )
    x = array.astype(np.float64)
    if intensity_range is None:
        intensity_range = (np.percentile(x, 0.95), np.percentile(x, 99.5))
    x = np.clip(x, intensity_range[0], intensity_range[1])
    std = x.std()
    x = (x - x.mean()) / std if std > 0 else np.zeros_like(x)
    lo, hi = x.min(), x.max()
    x = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return x.astype(np.float32)


def process_4d(array: np.ndarray, func) -> np.ndarray:
    """Apply a 3D function frame-wise over the trailing time axis
    (reference sitk.py:141-168).

    Args:
        array: (x, y, z, t).
        func: maps a (x, y, z) array to a processed array.

    Returns:
        stacked processed frames, shape (..., t).
    """
    if array.ndim != 4:
        raise ValueError(f"Array should have 4 dimensions, got {array.shape}.")
    return np.stack([func(array[..., t]) for t in range(array.shape[-1])], axis=-1)


def get_center_pad_size(
    current_size: Sequence[int],
    target_size: Sequence[int],
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Symmetric pad sizes reaching at least ``target_size``
    (reference sitk.py:303-328).

    Returns:
        (pad_lower, pad_upper) per axis; zero where already large enough.
    """
    pad_lower, pad_upper = [], []
    for i, size_i in enumerate(current_size):
        pad_i = max(int(target_size[i]) - int(size_i), 0)
        pad_lower.append(pad_i // 2)
        pad_upper.append(pad_i - pad_i // 2)
    return tuple(pad_lower), tuple(pad_upper)


def center_pad(
    array: np.ndarray,
    target_size: Sequence[int],
    value: float = 0,
) -> np.ndarray:
    """Symmetrically pad the leading spatial axes to ``target_size``
    (reference pad_4d / sitk.ConstantPad usage, sitk.py:330-353).

    Trailing axes beyond ``len(target_size)`` (time/channels) are untouched.
    """
    n = len(target_size)
    pad_lower, pad_upper = get_center_pad_size(array.shape[:n], target_size)
    pads = list(zip(pad_lower, pad_upper)) + [(0, 0)] * (array.ndim - n)
    return np.pad(array, pads, constant_values=value)


def get_invalid_bounding_box(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All -1 sentinel bbox for missing/empty labels (reference sitk.py:519-535)."""
    ndim_spatial = mask.ndim
    return -np.ones(ndim_spatial, np.int32), -np.ones(ndim_spatial, np.int32)


def get_valid_binary_mask_bounding_box(
    mask: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Foreground bbox as [start, end) per axis via per-axis max reduction
    (reference sitk.py:537-561); the full range when the mask is empty,
    matching the reference's argmax semantics.
    """
    bbox_min, bbox_max = [], []
    for axis in range(mask.ndim):
        reduced = np.amax(mask, axis=tuple(a for a in range(mask.ndim) if a != axis))
        bbox_min.append(int(np.argmax(reduced)))
        bbox_max.append(int(reduced.shape[0] - np.argmax(np.flip(reduced))))
    return np.asarray(bbox_min), np.asarray(bbox_max)


def cast_to_uint8(array: np.ndarray) -> np.ndarray:
    """Rescale to [0, 255] and cast (reference sitk.py:452-466)."""
    x = array.astype(np.float64)
    lo, hi = x.min(), x.max()
    if hi > lo:
        x = (x - lo) / (hi - lo) * 255.0
    else:
        x = np.zeros_like(x)
    return np.round(x).astype(np.uint8)


def get_binary_mask_bounding_box(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Min/max (exclusive) corners of the nonzero region (reference sitk.py:563-583).

    Returns:
        (bbox_min, bbox_max) arrays of per-axis indices; the full range when
        the mask is empty.
    """
    if not mask.any():
        return np.zeros(mask.ndim, dtype=int), np.array(mask.shape, dtype=int)
    coords = np.nonzero(mask)
    bbox_min = np.array([c.min() for c in coords])
    bbox_max = np.array([c.max() + 1 for c in coords])
    return bbox_min, bbox_max


def center_crop_xy(
    array: np.ndarray,
    center_xy: Sequence[float],
    size_xy: Sequence[int],
) -> np.ndarray:
    """Crop the first two axes to size around a center, end/zero padding as
    needed (reference crop_xy_3d/4d, sitk.py:380-450)."""
    out_shape = (int(size_xy[0]), int(size_xy[1])) + array.shape[2:]
    out = np.zeros(out_shape, dtype=array.dtype)
    starts = [int(round(c - s / 2)) for c, s in zip(center_xy, size_xy)]
    src, dst = [], []
    for axis, (start, size) in enumerate(zip(starts, size_xy)):
        lo = max(start, 0)
        hi = min(start + size, array.shape[axis])
        src.append(slice(lo, hi))
        dst.append(slice(lo - start, hi - start))
    out[tuple(dst)] = array[tuple(src)]
    return out


def pad_array(arr: np.ndarray, dim: int, n: int, value: float = 0) -> np.ndarray:
    """Symmetric-ish pad of one axis by n total (reference sitk.py:493-517)."""
    pads = [(0, 0)] * arr.ndim
    pads[dim] = (n // 2, n - n // 2)
    return np.pad(arr, pads, constant_values=value)


def get_sax_center_from_planes(
    sax_rot: np.ndarray,
    sax_origin: np.ndarray,
    lax_rots: Sequence[np.ndarray],
    lax_origins: Sequence[np.ndarray],
) -> Optional[np.ndarray]:
    """LV center on a SAX plane from two LAX plane intersections
    (reference get_lax_2c_4c_plane_intersection + get_sax_center,
    sitk.py:715-767): intersect the two LAX planes into a line, then the
    line with the SAX plane.
    """
    if len(lax_rots) != 2:
        raise ValueError("Need exactly two LAX planes.")
    line_point, line_vec = plane_plane_intersection(
        lax_rots[0], lax_origins[0], lax_rots[1], lax_origins[1]
    )
    return plane_line_intersection(sax_rot, sax_origin, line_point, line_vec)


def world_to_voxel(
    point: np.ndarray,
    rot: np.ndarray,
    origin: np.ndarray,
    spacing: Sequence[float],
) -> np.ndarray:
    """World coordinate -> continuous voxel index for an oriented image."""
    rel = np.linalg.solve(rot, np.asarray(point) - np.asarray(origin))
    return rel / np.asarray(spacing, dtype=np.float64)


def get_center_crop_size_from_1d_bbox(
    bbox_min: int,
    bbox_max: int,
    current_length: int,
    target_length: int,
) -> Tuple[int, int]:
    """Crop amounts centering the bbox, clamped to bounds
    (reference sitk.py:585-625)."""
    if bbox_min < 0 or bbox_max > current_length:
        raise ValueError("Label index out of range.")
    if current_length <= target_length:
        return 0, 0
    label_center = (bbox_max - 1 + bbox_min) / 2.0
    bbox_lower = int(np.ceil(label_center - target_length / 2.0))
    bbox_upper = bbox_lower + target_length
    bbox_lower = max(bbox_lower, 0)
    if bbox_upper > current_length:
        bbox_lower -= bbox_upper - current_length
    crop_lower = bbox_lower
    crop_upper = current_length - target_length - crop_lower
    return crop_lower, crop_upper


def get_center_crop_size_from_bbox(
    bbox_min: Sequence[int],
    bbox_max: Sequence[int],
    current_size: Sequence[int],
    target_size: Sequence[int],
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-axis crop sizes from a label bbox (reference sitk.py:628-660)."""
    lower, upper = [], []
    for i, current_length in enumerate(current_size):
        lo, up = get_center_crop_size_from_1d_bbox(
            int(bbox_min[i]), int(bbox_max[i]), int(current_length), int(target_size[i])
        )
        lower.append(lo)
        upper.append(up)
    return tuple(lower), tuple(upper)


def crop_with_sizes(array: np.ndarray, crop_lower: Sequence[int], crop_upper: Sequence[int]) -> np.ndarray:
    """Apply sitk.Crop-style lower/upper crops to the leading spatial axes.

    Extra trailing axes (time/channels) are untouched.
    """
    slices = tuple(
        slice(lo, array.shape[i] - up) for i, (lo, up) in enumerate(zip(crop_lower, crop_upper))
    )
    return array[slices]
