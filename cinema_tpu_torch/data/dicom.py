"""A DICOM reader in pure Python (port of cinema_tpu/data/dicom.py; the reference uses pydicom and
SimpleITK).

Reads the subset of DICOM that the cine-CMR pipelines need (reference cinema/data/dicom.py,
examples/dicom_to_nifti.py): single-frame uncompressed MR images in explicit or implicit VR little
endian, with the geometry and identification tags of series assembly: pixel data, spacing,
ImagePositionPatient and ImageOrientationPatient, series and instance metadata.

Raises on big endian, compressed transfer syntaxes and elements of undefined length.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# tag constants (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_SERIES_DESC = (0x0008, 0x103E)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_SLICE_LOCATION = (0x0020, 0x1041)
TAG_POSITION = (0x0020, 0x0032)
TAG_ORIENTATION = (0x0020, 0x0037)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_TRIGGER_TIME = (0x0018, 0x1060)
TAG_SPACING_BETWEEN_SLICES = (0x0018, 0x0088)
TAG_CARDIAC_NUMBER_OF_IMAGES = (0x0018, 0x1090)

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"

# VRs with a 2-byte reserved field + 4-byte length in explicit VR
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"UC", b"UR", b"OD", b"OL"}


@dataclass
class DicomImage:
    """Parsed single-frame DICOM."""

    pixel_array: np.ndarray  # (rows, cols)
    spacing: Tuple[float, float]  # row, col spacing in mm
    slice_thickness: float
    position: Tuple[float, float, float]
    orientation: Tuple[float, ...]  # 6 direction cosines
    series_uid: str
    series_description: str
    instance_number: int
    slice_location: Optional[float]
    trigger_time: Optional[float]
    elements: Dict[Tuple[int, int], bytes] = field(default_factory=dict)

    @property
    def rotation(self) -> np.ndarray:
        """(3,3) direction matrix: columns = row dir, col dir, normal
        (reference dicom.py orientation->rotation)."""
        row = np.asarray(self.orientation[:3], dtype=np.float64)
        col = np.asarray(self.orientation[3:6], dtype=np.float64)
        normal = np.cross(row, col)
        return np.stack([row, col, normal], axis=1)


def _read_elements(buf: bytes, offset: int, explicit: bool, stop_group: Optional[int] = None):
    """Yield (tag, vr, value_bytes) triples from a DICOM byte stream."""
    n = len(buf)
    while offset + 8 <= n:
        group, element = struct.unpack_from("<HH", buf, offset)
        if stop_group is not None and group != stop_group:
            return
        offset += 4
        if explicit and group != 0xFFFE:
            vr = buf[offset : offset + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            raise ValueError(
                f"Undefined-length element {group:04x},{element:04x} "
                "(compressed/sequence data) is not supported."
            )
        value = buf[offset : offset + length]
        offset += length
        yield (group, element), vr, value, offset


def _decode_str(value: bytes) -> str:
    return value.decode("ascii", errors="replace").strip("\x00 ").strip()


def _decode_floats(value: bytes) -> List[float]:
    text = _decode_str(value)
    return [float(x) for x in text.split("\\") if x]


def read_dicom(path: Union[str, Path]) -> DicomImage:
    """Read a single-frame uncompressed little-endian DICOM file."""
    buf = Path(path).read_bytes()
    if buf[128:132] != b"DICM":
        raise ValueError(f"{path} is not a DICOM part-10 file (missing DICM magic).")

    # file meta group (0002) is always explicit VR LE
    elements: Dict[Tuple[int, int], bytes] = {}
    offset = 132
    transfer_syntax = EXPLICIT_VR_LE
    for tag, _vr, value, offset in _read_elements(buf, offset, explicit=True, stop_group=0x0002):
        elements[tag] = value
        if tag == TAG_TRANSFER_SYNTAX:
            transfer_syntax = _decode_str(value)
    if transfer_syntax not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE):
        raise ValueError(f"Unsupported transfer syntax {transfer_syntax} (compressed?).")
    explicit = transfer_syntax == EXPLICIT_VR_LE

    pixel_data = None
    for tag, _vr, value, offset in _read_elements(buf, offset, explicit=explicit):
        elements[tag] = value
        if tag == TAG_PIXEL_DATA:
            pixel_data = value
            break
    if pixel_data is None:
        raise ValueError(f"{path} has no PixelData element.")

    rows = struct.unpack("<H", elements[TAG_ROWS])[0]
    cols = struct.unpack("<H", elements[TAG_COLS])[0]
    bits = struct.unpack("<H", elements.get(TAG_BITS_ALLOCATED, b"\x10\x00"))[0]
    signed = struct.unpack("<H", elements.get(TAG_PIXEL_REPRESENTATION, b"\x00\x00"))[0]
    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise ValueError(f"Unsupported BitsAllocated {bits}.")
    pixels = np.frombuffer(pixel_data, dtype=dtype, count=rows * cols).reshape(rows, cols)

    slope = _decode_floats(elements.get(TAG_RESCALE_SLOPE, b"1"))[0]
    intercept = _decode_floats(elements.get(TAG_RESCALE_INTERCEPT, b"0"))[0]
    if slope != 1.0 or intercept != 0.0:
        pixels = pixels.astype(np.float32) * slope + intercept

    spacing = _decode_floats(elements.get(TAG_PIXEL_SPACING, b"1\\1"))
    position = _decode_floats(elements.get(TAG_POSITION, b"0\\0\\0"))
    orientation = _decode_floats(elements.get(TAG_ORIENTATION, b"1\\0\\0\\0\\1\\0"))
    slice_location = (
        _decode_floats(elements[TAG_SLICE_LOCATION])[0] if TAG_SLICE_LOCATION in elements else None
    )
    trigger_time = (
        _decode_floats(elements[TAG_TRIGGER_TIME])[0] if TAG_TRIGGER_TIME in elements else None
    )
    return DicomImage(
        pixel_array=pixels,
        spacing=(spacing[0], spacing[1]),
        slice_thickness=_decode_floats(elements.get(TAG_SLICE_THICKNESS, b"1"))[0],
        position=tuple(position),
        orientation=tuple(orientation),
        series_uid=_decode_str(elements.get(TAG_SERIES_UID, b"")),
        series_description=_decode_str(elements.get(TAG_SERIES_DESC, b"")),
        instance_number=int(_decode_str(elements.get(TAG_INSTANCE_NUMBER, b"0")) or 0),
        slice_location=slice_location,
        trigger_time=trigger_time,
        elements=elements,
    )


def load_series(paths: Sequence[Union[str, Path]]) -> Tuple[np.ndarray, DicomImage]:
    """Assemble a sorted slice stack from one series' files.

    Sorts by slice location (falling back to instance number), stacks into
    (x, y, z) with ``arr[x, y, z]`` indexing like the NIfTI loader.

    Returns:
        (volume, first-slice DicomImage for geometry).
    """
    images = [read_dicom(p) for p in paths]
    series = {im.series_uid for im in images}
    if len(series) > 1:
        raise ValueError(f"Files span multiple series: {series}.")

    def sort_key(im: DicomImage):
        if im.slice_location is not None:
            return im.slice_location
        return float(im.instance_number)

    images.sort(key=sort_key)
    spacings = {im.spacing for im in images}
    if len(spacings) > 1:
        raise ValueError(f"Inconsistent pixel spacing within series: {spacings}.")
    volume = np.stack([im.pixel_array.T for im in images], axis=-1)  # (x, y, z)
    return volume, images[0]


def sort_cine_frames(images: List[DicomImage]) -> List[DicomImage]:
    """Order one slice's cine frames by trigger time (reference dicom.py 4D assembly)."""
    return sorted(images, key=lambda im: (im.trigger_time or 0.0, im.instance_number))


def _float_tag(im: DicomImage, tag: Tuple[int, int]) -> Optional[float]:
    value = im.elements.get(tag)
    if value is None:
        return None
    text = _decode_str(value)
    return float(text) if text else None


def _int_tag(im: DicomImage, tag: Tuple[int, int]) -> Optional[int]:
    value = _float_tag(im, tag)
    return int(value) if value is not None else None


def _scan_series(dcm_dir: Union[str, Path]) -> List[Tuple[Path, DicomImage]]:
    """Parse every ``*.dcm`` once and return (path, image) pairs of the
    lexicographically-last SeriesInstanceUID (missing UIDs — as in the
    Kaggle dataset — group together; reference cinema/data/dicom.py:23-47)."""
    series: Dict[str, List[Tuple[Path, DicomImage]]] = {}
    for f in sorted(Path(dcm_dir).glob("*.dcm")):
        img = read_dicom(f)
        series.setdefault(img.series_uid or "suid", []).append((f, img))
    if not series:
        raise ValueError(f"No .dcm files found in {dcm_dir}.")
    return sorted(series[sorted(series)[-1]], key=lambda pair: pair[0])


def find_series(dcm_dir: Union[str, Path]) -> List[Path]:
    """Files of the lexicographically-last series in a folder."""
    return [f for f, _img in _scan_series(dcm_dir)]


def load_dicom_folder(slice_dirs: Sequence[Union[str, Path]]):
    """Assemble one 4D cine volume from per-slice DICOM folders.

    Each folder holds one z-slice's cine frames; folders are ordered
    base->apex by the caller. Reproduces the reference's assembly
    (cinema/data/dicom.py:50-182):

    - geometry from the first slice's first frame, converted DICOM LPS ->
      NIfTI RAS by negating the x/y components of position and orientation;
    - z axis from the first->second slice origin difference (or the plane
      normal for single-slice stacks);
    - z spacing from SpacingBetweenSlices, else consecutive-origin distance,
      else SliceThickness;
    - per-slice frames ordered by TriggerTime; missing/short cine series
      copy the previous frame;
    - frame count from CardiacNumberOfImages (fallback: max frames seen).

    Returns:
        cinema_tpu_torch.data.volume.Volume with array (x, y, z, t) float32.
    """
    per_slice: List[List[DicomImage]] = []
    for d in slice_dirs:
        # single parse pass: _scan_series already decoded every file
        frames = [img for _f, img in _scan_series(d)]
        per_slice.append(sort_cine_frames(frames))
    return assemble_cine_volume(per_slice)


def load_series_frames(dcm_dir: Union[str, Path]) -> List[DicomImage]:
    """One folder's cine frames, parsed once and trigger-time sorted —
    reusable by callers that both inspect and assemble (kaggle filtering)."""
    return sort_cine_frames([img for _f, img in _scan_series(dcm_dir)])


def assemble_cine_volume(per_slice: Sequence[List[DicomImage]]):
    """Assemble a 4D cine volume from already-parsed per-slice frame lists
    (the geometry/ordering core of :func:`load_dicom_folder`)."""
    from cinema_tpu_torch.data.volume import Volume  # local import to avoid a cycle

    z = len(per_slice)
    if z == 0:
        raise ValueError("No slice directories given.")

    first = per_slice[0][0]
    nx, ny = first.pixel_array.shape[1], first.pixel_array.shape[0]  # cols, rows
    t = _int_tag(first, TAG_CARDIAC_NUMBER_OF_IMAGES) or max(len(f) for f in per_slice)
    dx, dy = first.spacing[1], first.spacing[0]  # PixelSpacing is (row, col)

    # LPS -> RAS: negate x/y components (reference dicom.py:71-92)
    pos_ul = np.asarray(first.position, dtype=np.float64)
    pos_ul[:2] = -pos_ul[:2]
    axis_x = np.asarray(first.orientation[:3], dtype=np.float64)
    axis_y = np.asarray(first.orientation[3:6], dtype=np.float64)
    axis_x[:2] = -axis_x[:2]
    axis_y[:2] = -axis_y[:2]

    pos_ul2 = None
    if z >= 2:
        second = per_slice[1][0]
        pos_ul2 = np.asarray(second.position, dtype=np.float64)
        pos_ul2[:2] = -pos_ul2[:2]
        axis_z = pos_ul2 - pos_ul
        axis_z = axis_z / np.linalg.norm(axis_z)
    else:
        axis_z = np.cross(axis_x, axis_y)

    dz = _float_tag(first, TAG_SPACING_BETWEEN_SLICES)
    if dz is None:
        dz = float(np.linalg.norm(pos_ul2 - pos_ul)) if pos_ul2 is not None else first.slice_thickness

    volume = np.zeros((nx, ny, z, t), dtype=np.float32)
    for k, frames in enumerate(per_slice):
        for j in range(t):
            if j < len(frames):
                volume[:, :, k, j] = frames[j].pixel_array.T  # (y,x) -> (x,y)
            else:
                volume[:, :, k, j] = volume[:, :, k, j - 1]

    rotation = np.stack([axis_x, axis_y, axis_z], axis=1)
    return Volume(array=volume, origin=pos_ul, spacing=np.array([dx, dy, dz]), rotation=rotation)
