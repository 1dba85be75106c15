"""The port's ``examples/cine_cmr.py`` (``cinema_tpu_torch.examples.cine_cmr``) against the JAX package's
script: its three geometry functions on seeded inputs and headers, its synthetic volume byte for byte, and its
picture (no matplotlib): the PNG's size and pixels, the outline colour at the projected corners of the slices
drawn after the textured one, the textured slice's gray levels, and a run with matplotlib and PIL unimportable."""

from __future__ import annotations

import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cinema_tpu_torch.data.nifti import load_nifti, load_nifti_header, save_nifti
from cinema_tpu_torch.examples import cine_cmr

REPO = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("jax_cine_cmr", REPO / "examples" / "cine_cmr.py")
jax_cine_cmr = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_cine_cmr)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("seed", range(4))
def test_geometry_functions_are_the_jax_scripts(tmp_path, seed):
    rng = np.random.default_rng(seed)
    rot, origin = _rotation(rng), rng.normal(size=3) * 50
    pixel_spacing, slice_spacing = tuple(rng.uniform(0.5, 2.0, 2)), float(rng.uniform(5, 10))
    x, y, z = (rng.uniform(0, 64, 20) for _ in range(3))
    np.testing.assert_array_equal(cine_cmr.image_to_real_space(x, y, z, rot, origin, pixel_spacing, slice_spacing),
                                  jax_cine_cmr.image_to_real_space(x, y, z, rot, origin, pixel_spacing, slice_spacing))
    for got, want in zip(cine_cmr.get_meshgrid(11, 7, 3, rot, origin, pixel_spacing, slice_spacing),
                         jax_cine_cmr.get_meshgrid(11, 7, 3, rot, origin, pixel_spacing, slice_spacing)):
        assert got.shape == (7, 11)
        np.testing.assert_array_equal(got, want)
    affine = np.eye(4)
    affine[:3, :3] = rot * np.array([*pixel_spacing, slice_spacing])[None, :]
    affine[:3, 3] = origin
    save_nifti(tmp_path / "v.nii.gz", np.zeros((5, 4, 3, 2), np.float32), spacing=(*pixel_spacing, slice_spacing, 1.0),
               affine=affine)
    from cinema_tpu.data.nifti import load_nifti_header as jax_load_nifti_header

    got = cine_cmr.geometry_from_header(load_nifti_header(tmp_path / "v.nii.gz"))
    want = jax_cine_cmr.geometry_from_header(jax_load_nifti_header(tmp_path / "v.nii.gz"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got[0], rot, atol=1e-6)


def test_synthetic_volume_is_the_jax_scripts_file(tmp_path):
    from tests.test_torch_port_preprocess import gzip_clock_at_zero

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    with gzip_clock_at_zero():
        jax_cine_cmr._synthetic_volume(tmp_path / "jax" / "synthetic_sax_t.nii.gz")
    cine_cmr._synthetic_volume(tmp_path / "port" / "synthetic_sax_t.nii.gz")
    assert (tmp_path / "port" / "synthetic_sax_t.nii.gz").read_bytes() == \
        (tmp_path / "jax" / "synthetic_sax_t.nii.gz").read_bytes()


def test_main_draws_the_outlines_at_the_projected_corners(tmp_path):
    from PIL import Image

    png = cine_cmr.main(["--out", str(tmp_path / "out" / "cine_cmr.png"), "--depth", "4", "--t", "1"])
    pixels = np.asarray(Image.open(png))
    assert pixels.shape == (cine_cmr.SIZE, cine_cmr.SIZE, 3) and pixels.dtype == np.uint8
    volume, header = load_nifti(tmp_path / "out" / "synthetic_sax_t.nii.gz")
    picture = cine_cmr.render_cmr_views(volume, header, 1, 4)
    np.testing.assert_array_equal(pixels, picture["canvas"])
    order = picture["order"]
    assert sorted(order) == sorted([("outline", d) for d in range(9)] + [("texture", 4)])
    assert order.index(("texture", 4)) == order.index(("outline", 4)) - 1  # the texture under its own outline
    after = order[order.index(("texture", 4)) + 1:]
    assert after
    for _, d in after:
        for r, c in picture["corners"][d]:
            assert tuple(pixels[int(round(r)), int(round(c))]) == cine_cmr.OUTLINE
    # the corners are the projection of the slices' world corners
    geometry = cine_cmr.geometry_from_header(header)
    corners = cine_cmr.slice_corners(volume.shape, geometry)
    right, up, eye = cine_cmr.view_axes()
    screen = picture["corners"]
    np.testing.assert_allclose(np.diff(screen[..., 1].reshape(-1)),
                               np.diff((corners @ right).reshape(-1)) * cine_cmr.Projection(corners.reshape(-1, 3)).scale,
                               atol=1e-9)
    # the textured slice's pixels are the frame's gray levels, floor(256 v) of the normalised frame
    levels = set(np.unique(cine_cmr._gray(volume[..., 4, 1])))
    inside = pixels[(pixels[..., 0] == pixels[..., 1]) & (pixels[..., 1] == pixels[..., 2]) & (pixels[..., 0] < 255)]
    assert inside.size and set(np.unique(inside[:, 0])) <= levels | {255}


def test_view_axes_are_matplotlibs():
    """At azim -90 and elev 0 matplotlib's x axis points right and z up; the axes are orthonormal."""
    right, up, eye = cine_cmr.view_axes(0.0, -90.0)
    np.testing.assert_allclose(right, [1, 0, 0], atol=1e-12)
    np.testing.assert_allclose(up, [0, 0, 1], atol=1e-12)
    right, up, eye = cine_cmr.view_axes()
    np.testing.assert_allclose(np.stack([right, up, eye]) @ np.stack([right, up, eye]).T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.cross(right, up), eye, atol=1e-12)


def test_main_runs_without_matplotlib_or_pil(tmp_path):
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('matplotlib', 'PIL', 'jax', 'cinema_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from cinema_tpu_torch.examples import cine_cmr\n"
            f"cine_cmr.main(['--out', {str(tmp_path / 'cine_cmr.png')!r}])\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120, capture_output=True)
    assert (tmp_path / "cine_cmr.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert io.BytesIO((tmp_path / "synthetic_sax_t.nii.gz").read_bytes()).read(2) == b"\x1f\x8b"
