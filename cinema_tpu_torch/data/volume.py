"""Oriented volumes: numpy arrays with world-space geometry (port of cinema_tpu/data/volume.py).

The JAX package's stand-in for the reference's sitk.Image plumbing (reference cinema/data/sitk.py): an
array in ``arr[x, y, z (, t)]`` layout with origin, spacing and direction, and the geometry-aware steps of
the DICOM-based pipelines: spacing resampling with the reference's origin shift (sitk.py:171-225), XY
crops that pad out of bounds and move the origin (crop_xy_3d/4d, sitk.py:380-450), the LV centre from
the LAX/SAX plane intersections (sitk.py:715-767) and the crop origin (get_origin_for_crop,
sitk.py:769-791). The time axis carries no geometry (process_4d, sitk.py:141-168). Host code.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage

from cinema_tpu_torch.data.geometry import (
    clip_and_normalise_intensity,
    plane_line_intersection,
    plane_plane_intersection,
)
from cinema_tpu_torch.data.nifti import save_nifti


@dataclass
class Volume:
    """A 3D(+t) image with world-space geometry.

    Attributes:
        array: (x, y, z) or (x, y, z, t).
        origin: (3,) world position of voxel (0, 0, 0).
        spacing: (3,) voxel spacing in mm.
        rotation: (3, 3) direction matrix; columns are the world directions
            of the x, y, z index axes.
    """

    array: np.ndarray
    origin: np.ndarray
    spacing: np.ndarray
    rotation: np.ndarray

    def __post_init__(self) -> None:
        self.origin = np.asarray(self.origin, dtype=np.float64).reshape(3)
        self.spacing = np.asarray(self.spacing, dtype=np.float64).reshape(3)
        self.rotation = np.asarray(self.rotation, dtype=np.float64).reshape(3, 3)
        if self.array.ndim not in (3, 4):
            raise ValueError(f"Volume array must be 3D or 4D, got {self.array.ndim}D.")

    @property
    def affine(self) -> np.ndarray:
        """4x4 voxel->world sform (NIfTI convention)."""
        affine = np.eye(4)
        affine[:3, :3] = self.rotation * self.spacing[None, :]
        affine[:3, 3] = self.origin
        return affine

    @property
    def size(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    def resample(self, target_spacing: Sequence[float], is_label: bool = False) -> "Volume":
        """Resample to a new spacing (reference resample_spacing_3d/4d,
        sitk.py:171-244).

        Output size is round(size * spacing / target); linear for images,
        nearest for labels; the origin shifts by 0.5 * (target - original)
        per world component (the reference's voxel-center convention,
        sitk.py:205-208 — applied component-wise without rotation, a pinned
        reference behavior). 4D arrays resample frame-wise.
        """
        target = np.asarray(target_spacing, dtype=np.float64).reshape(3)
        out_size = tuple(
            int(np.round(n * sp / tsp))
            for n, sp, tsp in zip(self.array.shape[:3], self.spacing, target)
        )
        order = 0 if is_label else 1

        def _resample_3d(arr: np.ndarray) -> np.ndarray:
            # sample the output grid at voxel centers of the new spacing,
            # like sitk.Resample with an identity transform
            coords = np.meshgrid(
                *[
                    (np.arange(m) * tsp + 0.5 * (tsp - sp)) / sp
                    for m, sp, tsp in zip(out_size, self.spacing, target)
                ],
                indexing="ij",
            )
            return ndimage.map_coordinates(
                arr.astype(np.float32) if order else arr,
                np.stack(coords),
                order=order,
                mode="constant",
                cval=0.0,
            )

        if self.array.ndim == 4:
            new = np.stack(
                [_resample_3d(self.array[..., t]) for t in range(self.array.shape[-1])],
                axis=-1,
            )
        else:
            new = _resample_3d(self.array)
        new_origin = self.origin + 0.5 * (target - self.spacing)
        return replace(self, array=new, origin=new_origin, spacing=target)

    def crop_xy(self, origin_indices: Tuple[int, int], slice_size: Tuple[int, int]) -> "Volume":
        """Crop the first two axes to ``slice_size`` starting at (possibly
        negative) ``origin_indices``, zero-padding out-of-bounds regions
        (reference crop_xy_3d/4d, sitk.py:380-450). The origin moves to the
        world position of the new first voxel.
        """
        x0, y0 = int(origin_indices[0]), int(origin_indices[1])
        out_shape = (int(slice_size[0]), int(slice_size[1])) + self.array.shape[2:]
        out = np.zeros(out_shape, dtype=self.array.dtype)
        src_x = slice(max(x0, 0), min(x0 + slice_size[0], self.array.shape[0]))
        src_y = slice(max(y0, 0), min(y0 + slice_size[1], self.array.shape[1]))
        if src_x.start < src_x.stop and src_y.start < src_y.stop:
            dst_x = slice(src_x.start - x0, src_x.stop - x0)
            dst_y = slice(src_y.start - y0, src_y.stop - y0)
            out[dst_x, dst_y] = self.array[src_x, src_y]
        shift = self.rotation @ (self.spacing * np.array([x0, y0, 0.0]))
        return replace(self, array=out, origin=self.origin + shift)

    def clip_and_normalise(
        self, intensity_range: Optional[Tuple[float, float]] = None
    ) -> "Volume":
        """Percentile clip -> z-norm -> [0,1] rescale, frame-wise for 4D
        (reference clip_and_normalise_intensity_3d/4d, sitk.py:246-330)."""
        return replace(self, array=clip_and_normalise_intensity(self.array, intensity_range))

    def to_uint8(self) -> "Volume":
        """Scale [0,1] data by 255 and cast (reference cast_to_uint8,
        sitk.py:452-466 — a plain *255, not a min/max rescale)."""
        return replace(self, array=np.round(self.array * 255.0).astype(np.uint8))

    def save(self, path: Union[str, Path], frame_indexed: bool = False) -> None:
        """Write as NIfTI-1 with the volume's sform affine.

        frame_indexed: write 4D .gz outputs with one gzip member per time
        frame for O(1) frame-seek reads (see data/nifti.py).
        """
        spacing = tuple(self.spacing) + ((1.0,) if self.array.ndim == 4 else ())
        save_nifti(
            path,
            self.array,
            spacing=spacing[: self.array.ndim],
            affine=self.affine,
            frame_indexed=frame_indexed,
        )


def get_origin_for_crop(
    center: np.ndarray, volume: Volume, slice_size: Tuple[int, int]
) -> Tuple[int, int]:
    """XY start indices so a ``slice_size`` crop is centered on a world point
    (reference get_origin_for_crop, sitk.py:769-791)."""
    indices = np.linalg.solve(volume.rotation, np.asarray(center, dtype=np.float64) - volume.origin)[:2]
    indices /= volume.spacing[:2]
    indices[0] -= (slice_size[0] - 1) / 2.0
    indices[1] -= (slice_size[1] - 1) / 2.0
    return int(indices[0]), int(indices[1])


def get_sax_center(sax: Volume, lax_2c: Volume, lax_4c: Volume) -> Optional[np.ndarray]:
    """LV center: intersect the 2C and 4C planes into a line, then that line
    with the SAX plane (reference get_lax_2c_4c_plane_intersection +
    get_sax_center, sitk.py:715-767)."""
    line_point, line_vec = plane_plane_intersection(
        lax_2c.rotation, lax_2c.origin, lax_4c.rotation, lax_4c.origin
    )
    return plane_line_intersection(sax.rotation, sax.origin, line_point, line_vec)


def point_to_plane_projection(
    point: np.ndarray, plane_origin: np.ndarray, plane_norm_vec: np.ndarray
) -> np.ndarray:
    """Orthogonal projection of a point onto a plane (reference
    examples/dicom_to_nifti.py:33-49, used to center the 3C crop)."""
    point = np.asarray(point, dtype=np.float64)
    plane_origin = np.asarray(plane_origin, dtype=np.float64)
    plane_norm_vec = np.asarray(plane_norm_vec, dtype=np.float64)
    distance = np.dot(point - plane_origin, plane_norm_vec)
    return point - distance * plane_norm_vec
