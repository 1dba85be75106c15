"""SAX cine slices in real (scanner) space (port of examples/cine_cmr.py; reference cinema/examples/cine_cmr.py).

Positions every SAX slice plane of a 4-D cine by its NIfTI affine (the geometry functions are the JAX
script's, in numpy) and draws the picture without matplotlib, which the machine with the card lacks: an
orthographic projection of the world coordinates, equal in every axis, seen from matplotlib's view of
the JAX script (``elev`` 35 degrees, ``azim`` -120 degrees). Every slice's outline is drawn in ``#6C8EBF``,
and the ``--depth`` slice is textured with frame ``--t``, normalised to 0-1 in gray (matplotlib's ``gray``
colour map), all in painter's order, farthest first, on a white 960x960 RGB PNG (``viz.write_png``). The
axis labels, ticks and legend of the JAX figure are left out: drawing text needs a font.

Usage:
    python -m cinema_tpu_torch.examples.cine_cmr --image path/to/patient_sax_t.nii.gz \
        --t 0 --depth 4 --out out/cine_cmr.png

With no ``--image``, a synthetic oriented 4-D volume (the JAX script's, byte for byte) is written next to
``--out`` and drawn.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cinema_tpu_torch.data.nifti import NiftiHeader, load_nifti, save_nifti
from cinema_tpu_torch.viz import _draw_line, write_png

OUTLINE = (0x6C, 0x8E, 0xBF)
ELEV, AZIM = 35.0, -120.0
SIZE, MARGIN = 960, 40


def image_to_real_space(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    rot: np.ndarray,
    origin: np.ndarray,
    pixel_spacing: Tuple[float, float],
    slice_spacing: float,
) -> np.ndarray:
    """Voxel indices (each (n_points,)) -> (3, n_points) world coordinates of an oriented slice stack:
    ``rot @ (index * spacing) + origin`` (reference cine_cmr.py:11-37)."""
    coords = np.array([x, y, z])
    spacing = np.array([pixel_spacing[0], pixel_spacing[1], slice_spacing])
    return rot @ (coords * spacing[:, None]) + np.asarray(origin)[:, None]


def get_meshgrid(
    height: int,
    width: int,
    z: int,
    rot: np.ndarray,
    origin: np.ndarray,
    pixel_spacing: Tuple[float, float],
    slice_spacing: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """World coordinates (x, y, z), each (width, height), of a grid over slice ``z`` from 0 to its width
    and height (reference cine_cmr.py:40-69)."""
    x, y = np.meshgrid(np.linspace(0, width, width), np.linspace(0, height, height), indexing="ij")
    zz = z + np.zeros((width, height))
    coords = image_to_real_space(x.reshape(-1), y.reshape(-1), zz.reshape(-1), rot, origin, pixel_spacing,
                                 slice_spacing)
    return coords[0].reshape(width, height), coords[1].reshape(width, height), coords[2].reshape(width, height)


def geometry_from_header(header: NiftiHeader) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float], float]:
    """A NIfTI affine split into (rot, origin, pixel_spacing, slice_spacing); a zero spacing divides by 1."""
    affine = np.asarray(header.affine, dtype=np.float64)
    spacing = np.asarray(header.spacing[:3], dtype=np.float64)
    safe = np.where(spacing > 0, spacing, 1.0)
    rot = affine[:3, :3] / safe[None, :]
    origin = affine[:3, 3]
    return rot, origin, (float(spacing[0]), float(spacing[1])), float(spacing[2])


def view_axes(elev: float = ELEV, azim: float = AZIM) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(right, up, towards the viewer) unit vectors of matplotlib's 3-D view at ``elev``, ``azim``
    (degrees)."""
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    return right, np.cross(eye, right), eye


def slice_corners(shape: Sequence[int], geometry: tuple) -> np.ndarray:
    """(depth, 4, 3) world coordinates of each slice's corners, in the JAX script's outline order."""
    width, height, depth = shape[:3]
    xs, ys = np.array([0, 0, width, width], np.float64), np.array([0, height, height, 0], np.float64)
    return np.stack([image_to_real_space(xs, ys, np.zeros(4) + d, *geometry).T for d in range(depth)])


class Projection:
    """World -> canvas (row, column) of an orthographic view fitted into the canvas with a margin."""

    def __init__(self, points: np.ndarray, size: int = SIZE, margin: int = MARGIN) -> None:
        self.right, self.up, self.eye = view_axes()
        u, v = points @ self.right, points @ self.up
        self.u0, self.v1 = u.min(), v.max()
        self.scale = (size - 1 - 2 * margin) / max(u.max() - u.min(), v.max() - v.min(), 1e-9)
        self.margin = margin

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """(..., 3) world -> (..., 2) canvas (row, column) floats."""
        rows = self.margin + (self.v1 - points @ self.up) * self.scale
        cols = self.margin + (points @ self.right - self.u0) * self.scale
        return np.stack([rows, cols], axis=-1)

    def depth(self, points: np.ndarray) -> np.ndarray:
        """Distance towards the viewer (larger is nearer)."""
        return points @ self.eye


def _gray(image: np.ndarray) -> np.ndarray:
    """The frame normalised to 0-1 and coloured by matplotlib's ``gray`` map: uint8 level floor(256 v)."""
    image = image.astype(np.float64)
    lo, hi = image.min(), image.max()
    image = (image - lo) / (hi - lo) if hi > lo else np.zeros_like(image)
    return np.minimum(np.floor(image * 256), 255).astype(np.uint8)


def _texture(canvas: np.ndarray, gray: np.ndarray, corners: np.ndarray) -> None:
    """The slice image ``gray`` (width, height) onto the parallelogram of its projected ``corners`` (4, 2):
    each canvas pixel inside takes the image pixel it falls in (nearest, no filtering)."""
    width, height = gray.shape
    origin, along_x, along_y = corners[0], (corners[3] - corners[0]) / width, (corners[1] - corners[0]) / height
    basis = np.stack([along_x, along_y], axis=1)  # (row, col) per unit of (x index, y index)
    if abs(np.linalg.det(basis)) < 1e-12:
        return  # the plane is seen edge-on: its outline is all there is to draw
    inverse = np.linalg.inv(basis)
    r0, c0 = np.floor(corners.min(axis=0)).astype(int)
    r1, c1 = np.ceil(corners.max(axis=0)).astype(int)
    r0, c0 = max(r0, 0), max(c0, 0)
    r1, c1 = min(r1, canvas.shape[0] - 1), min(c1, canvas.shape[1] - 1)
    rows, cols = np.mgrid[r0 : r1 + 1, c0 : c1 + 1]
    offsets = np.stack([rows - origin[0], cols - origin[1]], axis=-1).astype(np.float64)
    ij = offsets @ inverse.T  # (x index, y index) of each canvas pixel
    inside = (ij[..., 0] >= 0) & (ij[..., 0] < width) & (ij[..., 1] >= 0) & (ij[..., 1] < height)
    i = np.clip(ij[..., 0].astype(int), 0, width - 1)
    j = np.clip(ij[..., 1].astype(int), 0, height - 1)
    canvas[rows[inside], cols[inside]] = gray[i[inside], j[inside], None]


def render_cmr_views(volume: np.ndarray, header: NiftiHeader, t_to_show: int, depth_to_show: int) -> Dict:
    """The picture of :mod:`this script <cinema_tpu_torch.examples.cine_cmr>` (the JAX script's
    ``plot_cmr_views``, reference cine_cmr.py:74-160).

    Args:
        volume: (x, y, z, t) SAX cine.
        header: its NIfTI header (the affine).
        t_to_show: the frame to texture.
        depth_to_show: the slice to texture.

    Returns:
        ``canvas`` (SIZE, SIZE, 3) uint8; ``corners`` (depth, 4, 2) the slices' projected corners (row,
        column); ``order`` the draw order, farthest first, of ``("outline", d)`` and ``("texture", d)``.
    """
    geometry = geometry_from_header(header)
    corners = slice_corners(volume.shape, geometry)
    project = Projection(corners.reshape(-1, 3))
    screen = project(corners)
    depths = project.depth(corners).mean(axis=1)
    items: List[Tuple[float, int, str, int]] = [(depths[d], 1, "outline", d) for d in range(volume.shape[2])]
    if 0 <= depth_to_show < volume.shape[2]:
        items.append((depths[depth_to_show], 0, "texture", depth_to_show))  # under its own outline
    items.sort()
    canvas = np.full((SIZE, SIZE, 3), 255, np.uint8)
    for _, _, kind, d in items:
        if kind == "texture":
            _texture(canvas, _gray(volume[..., d, t_to_show]), screen[d])
        else:
            ring = list(screen[d]) + [screen[d][0]]
            for p0, p1 in zip(ring, ring[1:]):
                _draw_line(canvas, tuple(p0), tuple(p1), OUTLINE)
    return {"canvas": canvas, "corners": screen, "order": [(kind, d) for *_, kind, d in items]}


def _synthetic_volume(path: Path) -> Path:
    """Write the JAX script's small oriented 4-D SAX-like volume (64x64x9, 3 frames, rotated 30 degrees
    about x), the same bytes."""
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 255, size=(64, 64, 9, 3)).astype(np.float32)
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    spacing = np.array([1.0, 1.0, 10.0])
    affine = np.eye(4)
    affine[:3, :3] = rot * spacing[None, :]
    affine[:3, 3] = (-32.0, -32.0, -45.0)
    save_nifti(path, vol, spacing=(1.0, 1.0, 10.0, 1.0), affine=affine)
    return path


def main(argv: Optional[Sequence[str]] = None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image", type=Path, default=None, help="4D SAX NIfTI (x, y, z, t)")
    parser.add_argument("--t", type=int, default=0, help="frame to show")
    parser.add_argument("--depth", type=int, default=4, help="slice to texture")
    parser.add_argument("--out", type=Path, default=Path("out/cine_cmr.png"))
    args = parser.parse_args(argv)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    image_path = args.image or _synthetic_volume(args.out.parent / "synthetic_sax_t.nii.gz")
    volume, header = load_nifti(image_path)
    if volume.ndim != 4:
        raise ValueError(f"Expected a 4D cine volume, got shape {volume.shape}.")
    picture = render_cmr_views(volume, header, args.t, min(args.depth, volume.shape[2] - 1))
    write_png(args.out, picture["canvas"])
    print(f"saved {args.out}")
    return args.out


if __name__ == "__main__":
    main()
