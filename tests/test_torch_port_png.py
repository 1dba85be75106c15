"""The port's PNG reader (``cinema_tpu_torch.data.png``) against Pillow's ``Image.open(path).convert("L")``,
the way the JAX package reads every PNG.

Every colour type at every bit depth the PNG specification allows, plain and Adam7-interlaced, palettes with
and without ``tRNS`` and gray with ``tRNS``, on seeded images of at most 40x40 with odd widths (so that rows
of 1, 2 and 4-bit samples and the Adam7 passes end inside a byte), each row under one of the five filters. The
files are written by ``chip_smoke.encode_png`` (Pillow writes neither sub-byte gray nor interlaced PNGs). Files
that Pillow refuses are refused (``ValueError``), files that it reads though they are damaged (a bad IDAT CRC,
no IEND, the zlib check value cut off) read the same. Then the JAX landmark preprocessing and the port's on one
raw tree of such PNGs (``chip_smoke.write_raw_landmark_variants``).
"""

from __future__ import annotations

import importlib
import importlib.util
import io
import struct
import sys
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest

from cinema_tpu_torch.data import read_png_gray
from cinema_tpu_torch.data.png import BIT_DEPTHS, CHANNELS, decode_gray

_ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


encode = chip_smoke.encode_png  # every filter in turn, Adam7, a PLTE, the data in three IDATs


def with_chunk(png: bytes, kind: bytes, body: bytes) -> bytes:
    """``png`` with a chunk inserted before its first IDAT."""
    at = png.index(b"IDAT") - 4
    return png[:at] + chunk(kind, body) + png[at:]


def pil_gray(data: bytes):
    """Pillow's ``convert("L")`` of a PNG's bytes as the JAX dataset reads it, or the exception it raises."""
    from PIL import Image

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a palette's tRNS in a conversion to L
            return np.asarray(Image.open(io.BytesIO(data)).convert("L"), np.float32).T
    except Exception as e:  # noqa: BLE001 - any refusal of Pillow's
        return e


def _samples(rng, height, width, colour_type, depth, n_palette):
    channels = CHANNELS[colour_type]
    top = n_palette + 2 if colour_type == 3 else 1 << depth  # palette indices run past the PLTE's entries
    samples = rng.integers(0, min(top, 1 << depth), size=(height, width, channels))
    if depth == 16:  # values of 255 and below, where 16-bit gray's clipping does not apply, and above
        samples[: height // 3] %= 300
    return samples


CASES = [(ct, d) for ct, depths in BIT_DEPTHS.items() for d in depths]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour_type,depth", CASES, ids=[f"type{ct}-{d}bit" for ct, d in CASES])
def test_read_png_gray_is_pil_on_every_colour_type_and_bit_depth(tmp_path, colour_type, depth, interlace):
    rng = np.random.default_rng(100 * colour_type + depth + interlace)
    for height, width in ((13, 37), (40, 33), (1, 9), (7, 1), (3, 5)):
        n_palette = max(1, (1 << depth) - 3) if colour_type == 3 else 0
        plte = rng.integers(0, 256, size=(n_palette, 3)) if colour_type == 3 else None
        data = encode(_samples(rng, height, width, colour_type, depth, n_palette), colour_type, depth, interlace,
                      palette=plte)
        want = pil_gray(data)
        assert isinstance(want, np.ndarray), want
        path = tmp_path / f"{height}x{width}.png"
        path.write_bytes(data)
        got = read_png_gray(path)
        assert got.dtype == np.float32 and got.shape == (width, height)
        np.testing.assert_array_equal(got, want)


TRNS = {  # (colour type, depth, tRNS body)
    "palette-one-transparent": (3, 8, b"\xff\xff\x00\xff"),
    "palette-alphas": (3, 4, bytes([0, 128, 255, 7, 9])),
    "palette-1bit": (3, 1, b"\x00"),
    "gray-8bit": (0, 8, b"\x00\x2a"),
    "gray-1bit": (0, 1, b"\x00\x01"),
    "gray-16bit": (0, 16, b"\x01\x00"),
    "rgb-8bit": (2, 8, b"\x00\x10\x00\x20\x00\x30"),
    "rgb-16bit": (2, 16, b"\xff\xff\x00\x00\x12\x34"),
}


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("name", list(TRNS))
def test_read_png_gray_drops_trns_as_pil_does(tmp_path, name, interlace):
    colour_type, depth, trns = TRNS[name]
    rng = np.random.default_rng(len(name) + interlace)
    n_palette = 1 << depth if colour_type == 3 else 0
    plte = rng.integers(0, 256, size=(n_palette, 3)) if colour_type == 3 else None
    data = with_chunk(encode(_samples(rng, 21, 19, colour_type, depth, n_palette), colour_type, depth, interlace,
                             palette=plte), b"tRNS", trns)
    (tmp_path / "t.png").write_bytes(data)
    want = pil_gray(data)
    assert isinstance(want, np.ndarray), want
    np.testing.assert_array_equal(read_png_gray(tmp_path / "t.png"), want)


def test_sixteen_bit_gray_clips_and_sub_byte_gray_scales_as_pil_does():
    """What ``convert("L")`` does to gray below and above 8 bits, on values chosen by hand."""
    wide = np.array([0, 1, 255, 256, 1000, 65535]).reshape(1, 6, 1)
    assert decode_gray(encode(wide, 0, 16)).tolist() == [[0, 1, 255, 255, 255, 255]]
    assert decode_gray(encode(np.arange(4).reshape(1, 4, 1), 0, 2)).tolist() == [[0, 85, 170, 255]]
    assert decode_gray(encode(np.arange(2).reshape(1, 2, 1), 0, 1)).tolist() == [[0, 255]]
    rgb16 = np.array([[[65535, 0, 0], [256, 512, 1023]]])  # the high bytes (255, 0, 0) and (1, 2, 3)
    assert decode_gray(encode(rgb16, 2, 16)).tolist() == [[76, 2]]
    for data in (encode(wide, 0, 16), encode(rgb16, 2, 16)):
        np.testing.assert_array_equal(decode_gray(data).T, pil_gray(data))


def _image(depth=8, width=4, height=3):
    raw = b"".join(b"\x00" + ((np.arange(width) * 20 + 7 * r) % 256).astype(np.uint8).tobytes() for r in range(height))
    return raw, struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0)


def _file(raw, header, pre=b"", post=b"", iend=True, idat=None):
    body = zlib.compress(raw) if idat is None else idat
    return (SIGNATURE + chunk(b"IHDR", header) + pre + chunk(b"IDAT", body) + post
            + (chunk(b"IEND", b"") if iend else b""))


def _bad_crc(piece: bytes) -> bytes:
    return piece[:-1] + bytes([piece[-1] ^ 1])


def _damaged(name: str) -> bytes:
    raw, header = _image()
    good = _file(raw, header)
    compressed = zlib.compress(raw)
    parts = [chunk(b"IDAT", compressed[:5]), chunk(b"IDAT", compressed[5:])]
    head = SIGNATURE + chunk(b"IHDR", header)
    return {
        "not-a-png": b"GIF89a" + bytes(20),
        "bad-ihdr-crc": SIGNATURE + _bad_crc(chunk(b"IHDR", header)) + good[33:],
        "bad-crc-before-idat": _file(raw, header, pre=_bad_crc(chunk(b"tEXt", b"a\x00b"))),
        "bad-name-before-idat": _file(raw, header, pre=chunk(b"t-Xt", b"ab")),
        "truncated-ihdr": SIGNATURE + chunk(b"IHDR", header[:12]) + good[33:],
        "zero-width": _file(b"\x00" * 3, struct.pack(">IIBBBBB", 0, 3, 8, 0, 0, 0, 0)),
        "palette-16bit": _file(raw, struct.pack(">IIBBBBB", 4, 3, 16, 3, 0, 0, 0)),
        "rgb-4bit": _file(raw, struct.pack(">IIBBBBB", 4, 3, 4, 2, 0, 0, 0)),
        "filter-method-1": _file(raw, struct.pack(">IIBBBBB", 4, 3, 8, 0, 0, 1, 0)),
        "no-idat": SIGNATURE + chunk(b"IHDR", header) + chunk(b"IEND", b""),
        "truncated-data": _file(raw[:-2], header),
        "bad-filter-type": _file(b"\x05" + raw[1:], header),
        "corrupt-zlib": _file(raw, header, idat=b"\x78\x9c\xff\xff\xff\xff"),
        "bad-zlib-check": _file(raw, header, idat=compressed[:-1] + bytes([compressed[-1] ^ 1])),
        "idat-split-by-text": head + parts[0] + chunk(b"tEXt", b"a\x00b") + parts[1] + chunk(b"IEND", b""),
        "bad-name-inside-idat": head + parts[0] + chunk(b"t-Xt", b"") + parts[1] + chunk(b"IEND", b""),
        # read though damaged
        "bad-idat-crc": head + _bad_crc(parts[0]) + _bad_crc(parts[1]) + chunk(b"IEND", b""),
        "bad-crc-after-idat": _file(raw, header, post=_bad_crc(chunk(b"tEXt", b"a\x00b"))),
        "bad-name-after-idat": _file(raw, header, post=chunk(b"t-Xt", b"ab")),
        "no-iend": _file(raw, header, iend=False),
        "zlib-check-cut-off": good[:-20],
        "trailing-bytes": good + b"garbage",
        "extra-data-in-zlib": _file(raw + bytes(9), header),
        "ihdr-not-first": SIGNATURE + chunk(b"tEXt", b"a\x00b") + good[8:],
        "ihdr-of-14-bytes": SIGNATURE + chunk(b"IHDR", header + b"\x00") + good[33:],
        "compression-method-1": _file(raw, struct.pack(">IIBBBBB", 4, 3, 8, 0, 1, 0, 0)),
        "empty-idat-chunks": head + chunk(b"IDAT", b"") + parts[0] + chunk(b"IDAT", b"") + parts[1]
        + chunk(b"IEND", b""),
        "palette-without-plte": _file(raw, struct.pack(">IIBBBBB", 4, 3, 8, 3, 0, 0, 0)),
        "plte-of-5-bytes": _file(raw, struct.pack(">IIBBBBB", 4, 3, 8, 3, 0, 0, 0),
                                 pre=chunk(b"PLTE", bytes([1, 2, 3, 4, 5]))),
    }[name]


REFUSED = ["not-a-png", "bad-ihdr-crc", "bad-crc-before-idat", "bad-name-before-idat", "truncated-ihdr", "zero-width",
           "palette-16bit", "rgb-4bit", "filter-method-1", "no-idat", "truncated-data", "bad-filter-type",
           "corrupt-zlib", "bad-zlib-check", "idat-split-by-text", "bad-name-inside-idat"]
READ = ["bad-idat-crc", "bad-crc-after-idat", "bad-name-after-idat", "no-iend", "zlib-check-cut-off", "trailing-bytes",
        "extra-data-in-zlib", "ihdr-not-first", "ihdr-of-14-bytes", "compression-method-1", "empty-idat-chunks",
        "palette-without-plte", "plte-of-5-bytes"]


@pytest.mark.parametrize("name", REFUSED)
def test_read_png_gray_refuses_what_pil_refuses(tmp_path, name):
    data = _damaged(name)
    assert isinstance(pil_gray(data), Exception)
    (tmp_path / "x.png").write_bytes(data)
    with pytest.raises(ValueError):
        read_png_gray(tmp_path / "x.png")


@pytest.mark.parametrize("name", READ)
def test_read_png_gray_reads_damaged_files_that_pil_reads(tmp_path, name):
    data = _damaged(name)
    want = pil_gray(data)
    assert isinstance(want, np.ndarray), want
    (tmp_path / "x.png").write_bytes(data)
    np.testing.assert_array_equal(read_png_gray(tmp_path / "x.png"), want)


@pytest.mark.parametrize("variant", chip_smoke.PNG_VARIANTS)
def test_chip_smoke_png_variants_read_as_their_originals_in_pil_and_the_port(tmp_path, variant):
    image = np.random.RandomState(15).randint(0, 256, (37, 29)).astype(np.uint8)
    png, original = chip_smoke.png_variant(image, variant)
    (tmp_path / "v.png").write_bytes(png)
    np.testing.assert_array_equal(pil_gray(png), original.T.astype(np.float32))
    np.testing.assert_array_equal(read_png_gray(tmp_path / "v.png"), original.T.astype(np.float32))


def test_landmark_preprocessing_of_such_pngs_is_the_jax_clis(tmp_path):
    """The JAX landmark CLI (Pillow) and the port's on one raw tree of palette, 4-bit, Adam7 and 16-bit RGB PNGs
    write the same tables and the same pixels."""
    from cinema_tpu_torch.data.preprocess import landmark as port_landmark

    from tests.test_torch_port_preprocess import gzip_clock_at_zero

    chip_smoke.write_raw_landmark_variants(tmp_path / "raw", seed=16, size=(44, 36), n=10)
    jax_landmark = importlib.import_module("cinema_tpu.data.preprocess.landmark")
    saved = sys.argv
    try:
        with gzip_clock_at_zero():
            sys.argv = ["landmark_preprocess", "--data_dir", str(tmp_path / "raw"), "--out_dir",
                        str(tmp_path / "jax"), "--scale", "0.5"]
            jax_landmark.main()
    finally:
        sys.argv = saved
    port_landmark.main(["--data_dir", str(tmp_path / "raw"), "--out_dir", str(tmp_path / "port"), "--scale", "0.5"])
    assert chip_smoke.compare_trees(tmp_path / "port", tmp_path / "jax") == {}
    assert len(list((tmp_path / "port" / "lax_2c" / "images").glob("*.png"))) == 10
