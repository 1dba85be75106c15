"""The examples slice's small pieces against the JAX package and the libraries it uses: the constants, the
``CosineScheduler``, the port's ``viz`` (PNG and GIF writers without PIL, the volume curves' dict, the overlay
colour), ``read_png_gray`` on colour PNGs against PIL's ``convert("L")``, NIfTI in and out of ``serve``, and
the local-file rule of the example scripts.

The pictures themselves cannot equal matplotlib's; what is held is what the JAX functions return, what PIL
decodes from the files, and the overlay colour at labelled pixels.
"""

import importlib
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cinema_tpu_torch import constants, metrics, serve, viz
from cinema_tpu_torch.data import load_nifti, read_png_gray, save_nifti
from cinema_tpu_torch.train.optim import CosineScheduler

REPO = Path(__file__).resolve().parents[1]
SEG_SAX = next((REPO / "tests" / "fixtures" / "example_ckpts").glob("seg_sax-*"))


def test_constants_equal_the_jax_packages():
    from cinema_tpu import constants as jax_constants

    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names == [n for n in dir(constants) if n.isupper()]
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name
    assert metrics.REDUCED_EF is constants.REDUCED_EF and metrics.NORMAL_EF is constants.NORMAL_EF


# --- CosineScheduler ---------------------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(base=st.floats(-10, 10), final=st.floats(-10, 10), total=st.integers(0, 40), warmup=st.integers(0, 20),
       start=st.floats(-1, 1), freeze=st.integers(0, 20))
def test_cosine_scheduler_is_bit_equal_to_the_jax_one(base, final, total, warmup, start, freeze):
    from cinema_tpu.train.optim import CosineScheduler as JaxCosineScheduler

    args = (base, final, total, warmup, start, freeze)
    try:
        with np.errstate(all="ignore"):
            want = JaxCosineScheduler(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{e}$"):
            CosineScheduler(*args)
        return
    with np.errstate(all="ignore"):
        got = CosineScheduler(*args)
    np.testing.assert_array_equal(got.schedule, want.schedule)
    for it in range(total + 3):
        assert got[it] == want[it] or (np.isnan(got[it]) and np.isnan(want[it]))


def test_cosine_scheduler_past_the_end_is_the_final_value():
    sched = CosineScheduler(1.0, 0.25, total_iters=6, warmup_iters=2, freeze_iters=1)
    assert sched.schedule[:3].tolist() == [0.0, 0.0, 1.0]
    assert sched[6] == sched[100] == 0.25
    with pytest.raises(ValueError, match="should be equal to total_iters 3"):
        CosineScheduler(1.0, 0.0, total_iters=3, warmup_iters=4)


# --- PNG: write_png, read_png_gray on colour types -------------------------------------------------------------

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered_row(kind, row, prior, bpp):
    out = []
    for i, x in enumerate(row):
        a, b, c = (row[i - bpp] if i >= bpp else 0), prior[i], (prior[i - bpp] if i >= bpp else 0)
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((x - pred) % 256)
    return bytes([kind, *out])


def _handmade_png(pixels, colour_type, kinds):
    """An 8-bit PNG of ``pixels`` (rows, columns, samples) with filter ``kinds[r % len(kinds)]`` on row r."""
    height, width, bpp = pixels.shape
    prior, raw = [0] * (width * bpp), b""
    for r in range(height):
        row = [int(v) for v in pixels[r].reshape(-1)]
        raw += _filtered_row(kinds[r % len(kinds)], row, prior, bpp)
        prior = row
    header = struct.pack(">IIBBBBB", width, height, 8, colour_type, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pil_gray(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32).T


def _pixels(rng, height, width, samples):
    """Gradients, flat runs and noise in every sample, so that every filter has work."""
    yy, xx = np.mgrid[:height, :width]
    pixels = np.stack([(xx * (3 + s) + yy * (5 + 2 * s)) % 256 for s in range(samples)], axis=-1)
    pixels[: height // 3] = rng.integers(0, 256, size=(height // 3, width, samples))
    pixels[height // 2 : height // 2 + 2] = 255
    return pixels.astype(np.uint8)


@pytest.mark.parametrize("colour_type,samples", [(2, 3), (4, 2), (6, 4)], ids=["rgb", "gray-alpha", "rgba"])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "all-five"])
def test_read_png_gray_converts_colour_pngs_as_pil_does(tmp_path, colour_type, samples, kinds):
    pixels = _pixels(np.random.default_rng(colour_type), 19, 23, samples)
    path = tmp_path / "colour.png"
    path.write_bytes(_handmade_png(pixels, colour_type, kinds))
    got = read_png_gray(path)
    assert got.dtype == np.float32 and got.shape == (23, 19)
    np.testing.assert_array_equal(got, _pil_gray(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA"])
def test_read_png_gray_is_bit_equal_to_pil_on_colour_pngs_that_pil_writes(tmp_path, mode):
    from PIL import Image

    pixels = _pixels(np.random.default_rng(5), 64, 48, len(mode))
    path = tmp_path / "pil.png"
    Image.fromarray(pixels, mode).save(path, optimize=True)
    np.testing.assert_array_equal(read_png_gray(path), _pil_gray(path))


@pytest.mark.parametrize("shape", [(31, 17), (31, 17, 3)], ids=["gray", "rgb"])
def test_write_png_is_read_back_by_pil_and_by_read_png_gray(tmp_path, shape):
    from PIL import Image

    image = np.random.default_rng(6).integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "viz.png"
    viz.write_png(path, image)
    decoded = Image.open(path)
    assert decoded.mode == ("L" if len(shape) == 2 else "RGB")
    np.testing.assert_array_equal(np.asarray(decoded), image)
    np.testing.assert_array_equal(read_png_gray(path), _pil_gray(path))


# --- GIF ----------------------------------------------------------------------------------------------------

def _decode_gif(path):
    from PIL import Image, ImageSequence

    image = Image.open(path)
    frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(image)]
    return frames, image.info


@pytest.mark.parametrize("n_colours,shape", [(2, (1, 1)), (3, (300, 260)), (200, (37, 53)), (256, (90, 90))])
def test_gif_decodes_to_the_palette_frames_written(tmp_path, n_colours, shape):
    """Few colours over a large frame fill the LZW table and reset it; 256 noisy colours grow the codes
    to 12 bits quickly."""
    rng = np.random.default_rng(n_colours)
    palette = rng.choice(2**24, size=n_colours, replace=False)
    colours = np.stack([palette >> 16 & 255, palette >> 8 & 255, palette & 255], axis=-1).astype(np.uint8)
    frames = [colours[rng.integers(0, n_colours, size=shape)] for _ in range(3)]
    frames[1][: shape[0] // 2] = colours[0]  # long runs
    viz.save_gif(frames, tmp_path / "a.gif", duration_ms=70)
    decoded, info = _decode_gif(tmp_path / "a.gif")
    assert len(decoded) == 3 and info["duration"] == 70 and info["loop"] == 0
    for got, want in zip(decoded, frames):
        np.testing.assert_array_equal(got, want)


def test_gif_of_more_than_256_colours_quantizes_to_332_bins(tmp_path):
    frame = np.random.default_rng(3).integers(0, 256, size=(40, 30, 3), dtype=np.uint8)
    viz.save_gif([frame], tmp_path / "q.gif")
    (got,), _ = _decode_gif(tmp_path / "q.gif")
    want = np.stack([(frame[..., 0] >> 5) * 32 + 16, (frame[..., 1] >> 5) * 32 + 16, (frame[..., 2] >> 6) * 64 + 32],
                    axis=-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_step", [1, 2])
def test_segmentation_gif_frames_delay_and_overlay_colours(tmp_path, t_step):
    rng = np.random.default_rng(t_step)
    images = rng.normal(100, 30, size=(12, 10, 4, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=(12, 10, 4, 5))
    viz.plot_segmentations_gif(images, labels, tmp_path / "seg.gif", t_step=t_step)
    frames, info = _decode_gif(tmp_path / "seg.gif")
    assert len(frames) == len(range(0, 5, t_step)) and info["duration"] == 50 * t_step
    assert frames[0].shape == (2 * 12, 3 * 10, 3)  # 4 slices in a grid of 3 columns
    for i, t in enumerate(range(0, 5, t_step)):
        for z in range(4):
            r, c = z // 3, z % 3
            panel = frames[i][r * 12 : (r + 1) * 12, c * 10 : (c + 1) * 10].astype(np.float64)
            image = images[..., z, t]
            gray = (image - image.min()) / (image.max() - image.min())
            for value, (*colour, alpha) in viz._LABEL_RGBA.items():
                hit = labels[..., z, t] == value
                # matplotlib's composite of the JAX package's RGBA overlay on the gray panel
                composite = 255 * (alpha * np.asarray(colour) + (1 - alpha) * gray[hit, None])
                assert np.abs(panel[hit] - composite).max() <= 2.0, value
            plain = labels[..., z, t] == 0
            np.testing.assert_allclose(panel[plain], np.repeat(255 * gray[plain, None], 3, axis=-1), atol=2.5)
        assert (frames[i][12:, 10:] == 255).all()  # the grid's two empty cells are white


@pytest.mark.parametrize("case", ["both", "no-lv", "empty"])
def test_plot_volume_changes_returns_the_jax_functions_dict(tmp_path, case):
    from cinema_tpu.viz import plot_volume_changes as jax_plot_volume_changes

    labels = np.random.default_rng(4).integers(0, 4, size=(9, 8, 3, 6))
    if case == "no-lv":
        labels[labels == constants.LV_LABEL] = 0
    elif case == "empty":
        labels[:] = 0
    kwargs = dict(t_step=2, ml_per_voxel=0.0125)
    want = jax_plot_volume_changes(labels, tmp_path / "jax.png", dpi=20, **kwargs)
    got = viz.plot_volume_changes(labels, tmp_path / "port.png", **kwargs)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key] or (np.isnan(got[key]) and np.isnan(want[key])), key
    if case == "both":
        assert np.isfinite(got["lvef"]) and np.isfinite(got["rvef"])
    from PIL import Image

    assert Image.open(tmp_path / "port.png").size == (400, 400)


def test_plot_mae_reconstruction_is_one_row_per_slice_of_four_scaled_panels(tmp_path):
    rng = np.random.default_rng(7)
    image, recon = rng.random((8, 6, 3)), rng.random((8, 6, 3))
    mask = (rng.random((8, 6, 3)) > 0.5).astype(np.float32)
    viz.plot_mae_reconstruction(image, recon, mask, tmp_path / "mae.png")
    from PIL import Image

    grid = np.asarray(Image.open(tmp_path / "mae.png")).astype(np.float64)
    assert grid.shape == (3 * 8, 4 * 6)
    for z in range(3):
        for col, panel in enumerate((image, (1 - mask) * image, recon, np.abs(recon - image))):
            p = panel[..., z]
            want = np.round((p - p.min()) / (p.max() - p.min()) * 255)
            np.testing.assert_array_equal(grid[z * 8 : (z + 1) * 8, col * 6 : (col + 1) * 6], want)


# --- serve: NIfTI in and out ----------------------------------------------------------------------------------

@pytest.mark.parametrize("video_name,out_name", [("cine.nii.gz", "labels.nii.gz"), ("cine.nii", "labels.npy"),
                                                 ("cine.npy", "labels.nii")])
def test_serve_reads_and_writes_nifti_by_suffix(tmp_path, video_name, out_name):
    import yaml

    config = yaml.safe_load((SEG_SAX / "seg_sax.yaml").read_text())
    config["data"]["sax"]["patch_size"] = [32, 32, 4]  # the fixture's 16x16x4 is degenerate in torch
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    video = np.random.default_rng(2).integers(0, 200, size=(30, 26, 3, 5)).astype(np.uint8)
    spacing = (1.25, 1.5, 8.0, 1.0)
    if video_name.endswith(".npy"):
        np.save(tmp_path / video_name, video)
    else:
        save_nifti(tmp_path / video_name, video, spacing=spacing)
    serve.main(["--config", str(tmp_path / "config.yaml"), "--model", str(SEG_SAX / "seg_sax.safetensors"),
                "--video", str(tmp_path / video_name), "--out", str(tmp_path / out_name), "--device", "cpu"])
    from cinema_tpu_torch.factory import from_finetuned

    model = from_finetuned("convunetr", SEG_SAX / "seg_sax.safetensors", tmp_path / "config.yaml", device="cpu")
    want = serve.segment_cine(model, video.astype(np.float32))
    if out_name.endswith(".npy"):
        got = np.load(tmp_path / out_name)
    else:
        got, header = load_nifti(tmp_path / out_name)
        assert header.spacing == (spacing if not video_name.endswith(".npy") else (1.0,) * 4)
    assert got.dtype == np.uint8 and got.shape == video.shape
    np.testing.assert_array_equal(got, want)


# --- the examples' local-file rule ---------------------------------------------------------------------------

INFERENCE = ["segmentation_sax", "segmentation_lax_4c", "classification_cvd", "classification_sex",
             "classification_vendor", "regression_age", "regression_bmi", "regression_ef", "landmark_heatmap",
             "landmark_coordinate", "mae", "mae_feature_extraction"]
_INPUTS = {"segmentation_sax": ["--image", "x.nii.gz"], "segmentation_lax_4c": ["--image", "x.nii.gz"],
           "landmark_heatmap": ["--image", "x.png"], "landmark_coordinate": ["--image", "x.png"],
           "mae": ["--study_dir", "s"], "mae_feature_extraction": ["--study_dir", "s"]}


@pytest.mark.parametrize("name", INFERENCE)
@pytest.mark.parametrize("which", ["--model", "--config"])
def test_examples_refuse_huggingface_references(name, which):
    module = importlib.import_module(f"cinema_tpu_torch.examples.inference.{name}")
    argv = {"--model": "w.safetensors", "--config": "c.yaml"}
    argv[which] = "mathpluscode/CineMA::finetuned/config.yaml"
    inputs = _INPUTS.get(name, ["--ed", "ed.nii.gz", "--es", "es.nii.gz"])
    with pytest.raises(ValueError, match="local files"):
        module.main([*(x for kv in argv.items() for x in kv), *inputs, "--device", "cpu"])


def test_usage_text_says_weights_and_config_are_local_files(capsys):
    from cinema_tpu_torch.examples.inference import segmentation_sax

    with pytest.raises(SystemExit):
        segmentation_sax.main(["--help"])
    assert "local files" in " ".join(capsys.readouterr().out.split())
