"""The port's DICOM reader, image geometry and ``Volume`` (``cinema_tpu_torch.data.{dicom,geometry,volume}``)
against the JAX package's on the same inputs: the same pixels, tags, series order and assembled volumes from
hand-written explicit- and implicit-VR files, the same errors, and arrays equal exactly (no tolerance) from
the geometry and ``Volume`` functions on seeded inputs of drawn shapes and spacings, 3-D and 4-D."""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cinema_tpu.data import dicom as jax_dicom
from cinema_tpu.data import geometry as jax_geometry
from cinema_tpu.data import volume as jax_volume
from cinema_tpu_torch.data import dicom, geometry, volume
from tests.dicom_fixtures import LAX_2C_ORIENT, LAX_4C_ORIENT, SAX_ORIENT, make_kaggle_study, write_cine_slice_dir
from tests.test_dicom import _make_dicom
from tests.test_torch_port_preprocess import gzip_clock_at_zero

SETTINGS = settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])


def assert_same(got, want):
    """Equal exactly: arrays in dtype, shape and every element (NaN where NaN); tuples, lists and dicts item by
    item; anything else by ==."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), (got, want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (got, want)


def assert_same_call(name: str, *args, port=None, jax=None) -> None:
    """``port.name(*args)`` and ``jax.name(*args)`` give the same result, or raise the same error."""
    try:
        want = getattr(jax or jax_geometry, name)(*args)
    except Exception as e:  # noqa: BLE001 - the JAX function's error is the expected outcome
        with pytest.raises(type(e)) as got:
            getattr(port or geometry, name)(*args)
        assert str(got.value) == str(e)
        return
    assert_same(getattr(port or geometry, name)(*args), want)


def assert_same_image(got: dicom.DicomImage, want: jax_dicom.DicomImage) -> None:
    for field in ("pixel_array", "spacing", "slice_thickness", "position", "orientation", "series_uid",
                  "series_description", "instance_number", "slice_location", "trigger_time", "elements"):
        assert_same(getattr(got, field), getattr(want, field))
    assert_same(got.rotation, want.rotation)


def assert_same_volume(got: volume.Volume, want: jax_volume.Volume) -> None:
    for field in ("array", "origin", "spacing", "rotation"):
        assert_same(getattr(got, field), getattr(want, field))
    assert_same(got.affine, want.affine)


# --- the DICOM reader ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("tags", [{}, {"slice_location": b"12.5", "trigger_time": b"33.3", "position": b"-1.5\\2\\7"},
                                  {"spacing": b"0.7\\0.8", "series_uid": b"1.9.9.1", "instance": b"17"}],
                         ids=["plain", "location", "spacing"])
def test_read_dicom_is_the_jax_readers(tmp_path, implicit, tags):
    pixels = np.random.default_rng(0).integers(0, 4000, size=(9, 7), dtype=np.uint16)
    path = _make_dicom(tmp_path, "a.dcm", pixels, implicit=implicit, **tags)
    assert_same_image(dicom.read_dicom(path), jax_dicom.read_dicom(path))


def test_read_dicom_of_the_fixture_writer_with_rescale_and_signed_pixels(tmp_path):
    from tests.dicom_fixtures import write_dicom

    path = write_dicom(tmp_path / "b.dcm", np.arange(30, dtype=np.uint16).reshape(5, 6), position=(1, 2, 3),
                       orientation=LAX_2C_ORIENT, pixel_spacing=(1.25, 1.5), spacing_between_slices=8.0,
                       trigger_time=12.0, cardiac_number_of_images=25)
    assert_same_image(dicom.read_dicom(path), jax_dicom.read_dicom(path))
    # RescaleSlope / Intercept and signed 16-bit pixels: insert both before the pixel data
    data = bytearray(path.read_bytes())
    at = data.index(b"\xe0\x7f\x10\x00")
    extra = b"".join(
        [b"\x28\x00\x52\x10DS\x04\x00-10 ", b"\x28\x00\x53\x10DS\x04\x002.5 "])
    signed = data[:at].replace(b"\x28\x00\x03\x01US\x02\x00\x00\x00", b"\x28\x00\x03\x01US\x02\x00\x01\x00")
    path.write_bytes(bytes(signed) + extra + bytes(data[at:]))
    got, want = dicom.read_dicom(path), jax_dicom.read_dicom(path)
    assert want.pixel_array.dtype == np.float32
    assert_same_image(got, want)


@pytest.mark.parametrize("case", ["not-dicom", "compressed", "undefined-length", "no-pixels"])
def test_read_dicom_raises_as_the_jax_reader(tmp_path, case):
    path = tmp_path / "x.dcm"
    if case == "not-dicom":
        path.write_bytes(b"\x00" * 200)
    else:
        good = _make_dicom(tmp_path, "ok.dcm", np.zeros((2, 2), np.uint16)).read_bytes()
        if case == "compressed":  # explicit VR big endian: a syntax the reader refuses, of the same length
            data = good.replace(b"1.2.840.10008.1.2.1\x00", b"1.2.840.10008.1.2.2\x00", 1)
        elif case == "undefined-length":
            at = good.index(b"\xe0\x7f\x10\x00")
            data = good[:at] + b"\x09\x00\x10\x00OB\x00\x00\xff\xff\xff\xff" + good[at:]
        else:
            data = good[: good.index(b"\xe0\x7f\x10\x00")]
        path.write_bytes(data)
    with pytest.raises(ValueError) as want:
        jax_dicom.read_dicom(path)
    with pytest.raises(ValueError) as got:
        dicom.read_dicom(path)
    assert str(got.value) == str(want.value)


def test_series_order_and_cine_sort_are_the_jax_readers(tmp_path):
    paths = [_make_dicom(tmp_path, f"s{i}.dcm", np.full((4, 3), i, np.uint16), instance=str(9 - i).encode(),
                         slice_location=loc, trigger_time=str(30 * ((i * 7) % 5)).encode())
             for i, loc in enumerate([b"20.0", None, b"-5.5", None, b"10.0"])]
    (got_volume, got_first), (want_volume, want_first) = dicom.load_series(paths), jax_dicom.load_series(paths)
    assert_same(got_volume, want_volume)
    assert_same_image(got_first, want_first)
    got = dicom.sort_cine_frames([dicom.read_dicom(p) for p in paths])
    want = jax_dicom.sort_cine_frames([jax_dicom.read_dicom(p) for p in paths])
    assert [im.instance_number for im in got] == [im.instance_number for im in want]
    mixed = [paths[0], _make_dicom(tmp_path, "other.dcm", np.zeros((4, 3), np.uint16), series_uid=b"7.7")]
    with pytest.raises(ValueError, match="multiple series"):
        dicom.load_series(mixed)


def test_find_series_and_cine_folders_are_the_jax_readers(tmp_path):
    for uid, seed in (("1.2.3", 0), ("1.2.10", 1)):  # the lexicographically last series wins
        write_cine_slice_dir(tmp_path / "mixed", 6, 5, 3, series_uid=uid, seed=seed, file_prefix=f"S{seed}")
    assert dicom.find_series(tmp_path / "mixed") == jax_dicom.find_series(tmp_path / "mixed")
    got, want = dicom.load_series_frames(tmp_path / "mixed"), jax_dicom.load_series_frames(tmp_path / "mixed")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same_image(a, b)
    make_kaggle_study(tmp_path / "study", n_sax=3, n_frames=4)
    sax = sorted((tmp_path / "study").glob("sax_*"))
    assert_same_volume(dicom.load_dicom_folder(sax), jax_dicom.load_dicom_folder(sax))
    lax = [tmp_path / "study" / "2ch_21"]
    assert_same_volume(dicom.load_dicom_folder(lax), jax_dicom.load_dicom_folder(lax))
    # a short cine slice copies its previous frame; the frame count from CardiacNumberOfImages
    short = [dicom.load_series_frames(d) for d in sax]
    short[1] = short[1][:2]
    want_short = [jax_dicom.load_series_frames(d) for d in sax]
    want_short[1] = want_short[1][:2]
    assert_same_volume(dicom.assemble_cine_volume(short), jax_dicom.assemble_cine_volume(want_short))
    with pytest.raises(ValueError, match="No .dcm files"):
        dicom.find_series(tmp_path)


# --- the geometry helpers -------------------------------------------------------------------------------------

spacings = st.tuples(*[st.sampled_from([0.7, 1.0, 1.25, 1.458, 1.5625, 1.8, 2.0])] * 2,
                     st.sampled_from([5.0, 8.0, 10.0, 12.0]))


@SETTINGS
@given(shape=st.tuples(st.integers(3, 14), st.integers(3, 14), st.integers(1, 5)), spacing=spacings,
       frames=st.sampled_from([0, 1, 3]), seed=st.integers(0, 2**16))
def test_intensity_and_resampling_are_the_jax_packages(shape, spacing, frames, seed):
    rng = np.random.default_rng(seed)
    array = (rng.normal(100, 40, (*shape, frames) if frames else shape) * rng.uniform(0.2, 5)).astype(np.float32)
    label = rng.integers(0, 4, array.shape).astype(np.uint8)
    target = (1.0, 1.0, 10.0)
    assert_same_call("resample_spacing", array, spacing, target)
    assert_same(geometry.resample_spacing(label, spacing, target, is_label=True),
                jax_geometry.resample_spacing(label, spacing, target, is_label=True))
    assert_same(geometry.clip_and_normalise_intensity(array), jax_geometry.clip_and_normalise_intensity(array))
    assert_same(geometry.clip_and_normalise_intensity(array, (80.0, 120.0)),
                jax_geometry.clip_and_normalise_intensity(array, (80.0, 120.0)))
    assert_same(geometry.cast_to_uint8(array), jax_geometry.cast_to_uint8(array))
    assert_same(geometry.cast_to_uint8(np.full(shape, 3.0)), jax_geometry.cast_to_uint8(np.full(shape, 3.0)))
    if frames:
        assert_same(geometry.process_4d(array, np.flipud), jax_geometry.process_4d(array, np.flipud))


@SETTINGS
@given(shape=st.tuples(st.integers(2, 30), st.integers(2, 30), st.integers(1, 6)), seed=st.integers(0, 2**16),
       target=st.tuples(st.integers(1, 24), st.integers(1, 24), st.integers(1, 6)), empty=st.booleans())
def test_boxes_crops_and_pads_are_the_jax_packages(shape, seed, target, empty):
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape, bool) if empty else rng.uniform(size=shape) > 0.97
    if not empty:
        mask[tuple(int(rng.integers(0, s)) for s in shape)] = True
    array = rng.integers(0, 255, (*shape, 2)).astype(np.uint8)
    for fn in ("get_binary_mask_bounding_box", "get_valid_binary_mask_bounding_box", "get_invalid_bounding_box"):
        assert_same(getattr(geometry, fn)(mask), getattr(jax_geometry, fn)(mask))
    bbox_min, bbox_max = jax_geometry.get_binary_mask_bounding_box(mask)
    lower, upper = jax_geometry.get_center_crop_size_from_bbox(bbox_min, bbox_max, shape, target)
    assert_same(geometry.get_center_crop_size_from_bbox(bbox_min, bbox_max, shape, target), (lower, upper))
    assert_same_call("crop_with_sizes", array, lower, upper)
    assert_same_call("get_center_pad_size", shape, target)
    assert_same_call("center_pad", array, target, 7)
    assert_same_call("center_crop_xy", array, rng.uniform(-5, 35, 2), target[:2])  # raises for some crops
    assert_same_call("pad_array", array, 1, target[1], 3)
    with pytest.raises(ValueError, match="out of range"):
        geometry.get_center_crop_size_from_1d_bbox(-1, 2, 5, 3)


def _rotation(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q


@SETTINGS
@given(seed=st.integers(0, 2**16))
def test_plane_geometry_is_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    rots, origins = [_rotation(rng) for _ in range(3)], [rng.normal(0, 30, 3) for _ in range(3)]
    assert_same(geometry.plane_plane_intersection(rots[0], origins[0], rots[1], origins[1]),
                jax_geometry.plane_plane_intersection(rots[0], origins[0], rots[1], origins[1]))
    point, vec = jax_geometry.plane_plane_intersection(rots[0], origins[0], rots[1], origins[1])
    assert_same(geometry.plane_line_intersection(rots[2], origins[2], point, vec),
                jax_geometry.plane_line_intersection(rots[2], origins[2], point, vec))
    assert geometry.plane_line_intersection(rots[0], origins[0], point, vec, epsilon=1.0) is None
    assert_same(geometry.get_sax_center_from_planes(rots[2], origins[2], rots[:2], origins[:2]),
                jax_geometry.get_sax_center_from_planes(rots[2], origins[2], rots[:2], origins[:2]))
    spacing = rng.uniform(0.5, 3, 3)
    assert_same(geometry.world_to_voxel(point, rots[2], origins[2], spacing),
                jax_geometry.world_to_voxel(point, rots[2], origins[2], spacing))


# --- Volume -------------------------------------------------------------------------------------------------

def _volumes(seed: int, shape: tuple, spacing: tuple):
    rng = np.random.default_rng(seed)
    array = rng.normal(300, 80, shape).astype(np.float32)
    geometry_args = dict(origin=rng.normal(0, 20, 3), spacing=spacing, rotation=_rotation(rng))
    return volume.Volume(array=array.copy(), **geometry_args), jax_volume.Volume(array=array.copy(), **geometry_args)


@SETTINGS
@given(shape=st.sampled_from([(9, 11, 3), (12, 7, 2, 3), (10, 10, 1, 4)]), spacing=spacings,
       seed=st.integers(0, 2**16), crop=st.tuples(st.integers(-8, 8), st.integers(-8, 8), st.integers(4, 20),
                                                  st.integers(4, 20)))
def test_volume_is_the_jax_packages(shape, spacing, seed, crop):
    got, want = _volumes(seed, shape, spacing)
    assert_same_volume(got, want)
    target = (1.0, 1.0, spacing[2] if len(shape) == 4 else 10.0)
    assert_same_volume(got.resample(target), want.resample(target))
    label_got, label_want = got.__class__(got.array.astype(np.uint8) % 4, got.origin, got.spacing, got.rotation), \
        want.__class__(want.array.astype(np.uint8) % 4, want.origin, want.spacing, want.rotation)
    assert_same_volume(label_got.resample(target, is_label=True), label_want.resample(target, is_label=True))
    assert_same_volume(got.crop_xy(crop[:2], crop[2:]), want.crop_xy(crop[:2], crop[2:]))
    assert_same_volume(got.clip_and_normalise(), want.clip_and_normalise())
    assert_same_volume(got.clip_and_normalise().to_uint8(), want.clip_and_normalise().to_uint8())
    centre = want.origin + want.rotation @ (want.spacing * (3.3, 2.2, 0.5))
    assert_same(volume.get_origin_for_crop(centre, got, (6, 5)), jax_volume.get_origin_for_crop(centre, want, (6, 5)))
    normal = want.rotation[:, -1]
    assert_same(volume.point_to_plane_projection(centre + 2.5 * normal, got.origin, normal),
                jax_volume.point_to_plane_projection(centre + 2.5 * normal, want.origin, normal))
    with pytest.raises(ValueError, match="3D or 4D"):
        volume.Volume(array=np.zeros((2, 2)), origin=got.origin, spacing=got.spacing, rotation=got.rotation)


def test_sax_centre_and_saved_volumes_are_the_jax_packages(tmp_path):
    def oriented(orientation, position, shape):
        row, col = np.array(orientation[:3], float), np.array(orientation[3:], float)
        rotation = np.stack([row, col, np.cross(row, col)], axis=1)
        return [cls(array=np.ones(shape, np.float32), origin=np.array(position, float), spacing=(1.8, 1.8, 8.0),
                    rotation=rotation) for cls in (volume.Volume, jax_volume.Volume)]

    sax = oriented(SAX_ORIENT, (-12, -12, 0), (20, 24, 3, 2))
    lax_2c = oriented(LAX_2C_ORIENT, (5, -10, -10), (20, 24, 1, 2))
    lax_4c = oriented(LAX_4C_ORIENT, (-10, 6, -10), (20, 24, 1, 2))
    assert_same(volume.get_sax_center(sax[0], lax_2c[0], lax_4c[0]),
                jax_volume.get_sax_center(sax[1], lax_2c[1], lax_4c[1]))
    # the files: the JAX package's gzip stream with its clock at 0, as the port writes every stream
    for frame_indexed in (False, True):
        got, want = _volumes(3, (8, 6, 2, 3), (1.25, 1.5, 8.0))
        got.save(tmp_path / "port.nii.gz", frame_indexed=frame_indexed)
        with gzip_clock_at_zero():
            want.save(tmp_path / "jax.nii.gz", frame_indexed=frame_indexed)
        port, jax = (tmp_path / "port.nii.gz").read_bytes(), (tmp_path / "jax.nii.gz").read_bytes()
        if not frame_indexed:  # gzip's FNAME field names the file
            port, jax = port.replace(b"port.nii", b"jax.nii"), jax
        assert port == jax
