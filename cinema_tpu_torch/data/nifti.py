"""NIfTI-1 reader and writer with frame seeks (port of cinema_tpu/data/nifti.py:57-366).

Little-endian NIfTI-1, a 348-byte header and the raw voxels, plain (``.nii``) or
gzipped (``.nii.gz``), in the eight voxel types of ``_DTYPES``, with the header's
``scl_slope`` / ``scl_inter`` scaling. Arrays use ``arr[x, y, z(, t)]`` indexing, the
transposed order of the x-fastest storage, as the JAX package's preprocessing writes
and reads them.

Frame seeks: time is the slowest storage axis of a 4-D cine, so :func:`load_nifti_frame`
reads one frame alone, by a seek in a ``.nii`` and by inflating the stream's prefix up to
the frame's end in a ``.nii.gz``. ``save_nifti(..., frame_indexed=True)`` writes a 4-D
``.nii.gz`` as one gzip member per frame (RFC 1952 lets a stream be a concatenation of
members, and every reader decodes it as one), with the members' byte offsets in an FEXTRA
subfield ``CT`` of member 0, so that a frame read inflates one member. A frame read inflates
in C++ where the native reader runs (``cinema_tpu_torch.native``; ``native.reader()`` says
which), else with Python's ``zlib``; the bytes are the same. Where the native reader refuses
a stream that Python reads, the read is logged and Python reads it (``CINEMA_TORCH_NATIVE=1``: it raises).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Optional, Sequence, Tuple, Union

import numpy as np

from cinema_tpu_torch import native
from cinema_tpu_torch.log import get_logger

logger = get_logger(__name__)

_DTYPES = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiHeader:
    """The fields of a NIfTI-1 header that the port reads."""

    shape: Tuple[int, ...]
    dtype: np.dtype
    spacing: Tuple[float, ...]
    affine: np.ndarray  # 4x4 voxel -> world
    vox_offset: int
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    descrip: bytes = b""


def _open(path: Union[str, Path], mode: str = "rb") -> BinaryIO:
    path = Path(path)
    if path.suffix == ".gz":
        # gzip.open's stream with the header's time stamp 0 (gzip.open writes the clock's): the same array
        # written twice gives the same bytes
        return gzip.GzipFile(path, mode, mtime=0)  # type: ignore[return-value]
    return open(path, mode)


def _parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"NIfTI header too short: {len(raw)} bytes.")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != HEADER_SIZE:
        raise ValueError(f"Not a little-endian NIfTI-1 file (sizeof_hdr={sizeof_hdr}).")
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"Bad NIfTI magic: {magic!r}.")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    if ndim < 1 or ndim > 7:
        raise ValueError(f"Unsupported ndim {ndim}.")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}.")
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    sform_code = struct.unpack_from("<h", raw, 254)[0]
    affine = np.eye(4)
    if sform_code > 0:
        affine[:3] = np.reshape(struct.unpack_from("<12f", raw, 280), (3, 4))
    else:
        for i in range(3):
            affine[i, i] = pixdim[i + 1] if i < ndim else 1.0
    return NiftiHeader(
        shape=shape,
        dtype=_DTYPES[datatype],
        spacing=tuple(float(abs(p)) if p != 0 else 1.0 for p in pixdim[1 : 1 + ndim]),
        affine=affine,
        vox_offset=max(vox_offset, HEADER_SIZE + 4),
        scl_slope=float(scl_slope) if scl_slope != 0 else 1.0,
        scl_inter=float(scl_inter),
        descrip=raw[148:228].rstrip(b"\x00"),
    )


def load_nifti_header(path: Union[str, Path]) -> NiftiHeader:
    """The header alone."""
    with _open(path) as f:
        return _parse_header(f.read(HEADER_SIZE))


# ---- frame-indexed gzip: one member per frame and an offset table in member 0 ----

_FIDX_SI = b"CT"  # the FEXTRA subfield id of the frame-offset table


def _gzip_member(payload: bytes, extra: bytes = b"", level: int = 6) -> bytes:
    """One complete RFC 1952 gzip member (mtime 0, OS unknown), with an FEXTRA field where ``extra`` is given."""
    flg = 0x04 if extra else 0x00
    hdr = struct.pack("<2sBBIBB", b"\x1f\x8b", 8, flg, 0, 0, 255)
    if extra:
        hdr += struct.pack("<H", len(extra)) + extra
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(payload) + co.flush()
    return hdr + body + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload) & 0xFFFFFFFF)


def read_frame_index(path: Union[str, Path]) -> Optional[np.ndarray]:
    """The absolute byte offsets (nt + 1,) of the per-frame gzip members of a file that
    ``save_nifti(..., frame_indexed=True)`` wrote; None for any other file (a single-member
    gzip, a raw ``.nii``, a foreign FEXTRA field)."""
    try:
        with open(path, "rb") as f:
            head = f.read(14)
            if len(head) < 14 or head[:2] != b"\x1f\x8b" or not (head[3] & 0x04):
                return None
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = head[12:14] + f.read(xlen - 2) if xlen >= 2 else b""
    except OSError:
        return None
    pos = 0
    while pos + 4 <= len(extra):
        si, sub_len = extra[pos : pos + 2], struct.unpack_from("<H", extra, pos + 2)[0]
        data = extra[pos + 4 : pos + 4 + sub_len]
        if si == _FIDX_SI and len(data) == sub_len and sub_len >= 12:
            nt = struct.unpack_from("<I", data, 0)[0]
            if sub_len == 4 + 8 * (nt + 1):
                return np.frombuffer(data, dtype="<u8", count=nt + 1, offset=4)
        pos += 4 + sub_len
    return None


def _native_or_none(read, path: Path, *args):
    """``read(path, *args)`` of the native reader: its buffer, or None where Python is to read (the Python
    reader runs, or the native one refused the stream: logged, or raised where ``native.required()``)."""
    try:
        return read(path, *args)
    except IOError as e:
        if native.required():
            raise
        logger.warning(f"native frame read failed ({e}); reading {path} with Python")
        return None


def _read_member(path: Path, start: int, end: int, nbytes: int) -> Union[bytes, np.ndarray]:
    """The first ``nbytes`` of the gzip member at the byte range [start, end), inflated."""
    buf = _native_or_none(native.inflate_at, path, start, end - start, nbytes)
    if buf is not None:
        return buf
    with open(path, "rb") as f:
        f.seek(start)
        comp = f.read(end - start)
    return zlib.decompressobj(wbits=31).decompress(comp, nbytes)


def _seek_read(path: Path, offset: int, nbytes: int) -> Union[bytes, np.ndarray]:
    """``nbytes`` of the voxel stream from ``offset``: a seek in a ``.nii``; in a ``.nii.gz`` the stream's
    prefix is inflated up to there (a gzip stream can only be read in order)."""
    buf = _native_or_none(native.read_at, path, offset, nbytes)
    if buf is not None:
        return buf
    with _open(path) as f:
        f.seek(offset)
        return f.read(nbytes)


def load_nifti(path: Union[str, Path], apply_scaling: bool = True) -> Tuple[np.ndarray, NiftiHeader]:
    """A whole NIfTI volume: (the array of ``header.shape``, indexed ``arr[x, y, ...]``, the header).

    Where the header's scaling is not the identity, the voxels are returned as float32
    ``stored * scl_slope + scl_inter``; ``apply_scaling=False`` returns the stored voxels.
    """
    with _open(path) as f:
        raw = f.read()
    header = _parse_header(raw[:HEADER_SIZE])
    data = np.frombuffer(raw, dtype=header.dtype, count=int(np.prod(header.shape)), offset=header.vox_offset)
    # x is stored fastest: the C-order view has the axes reversed
    arr = data.reshape(header.shape[::-1]).transpose(tuple(range(len(header.shape) - 1, -1, -1)))
    if apply_scaling and (header.scl_slope != 1.0 or header.scl_inter != 0.0):
        arr = arr.astype(np.float32) * header.scl_slope + header.scl_inter
    return np.ascontiguousarray(arr), header


def load_nifti_frame(path: Union[str, Path], t: int) -> Tuple[np.ndarray, NiftiHeader]:
    """Frame ``t`` of a 4-D NIfTI, read without the rest: ((nx, ny, nz) array, header).

    A frame-indexed ``.nii.gz`` inflates frame t's member alone; any other ``.nii.gz`` the
    stream up to the frame's end; a ``.nii`` seeks to it. The header's scaling is applied as
    :func:`load_nifti` applies it. A volume that is not 4-D, or ``t`` outside [0, nt), raises
    ``ValueError``.
    """
    path = Path(path)
    header = load_nifti_header(path)
    if len(header.shape) != 4:
        raise ValueError(f"Expected 4D volume, got shape {header.shape}.")
    nx, ny, nz, nt = header.shape
    if not 0 <= t < nt:
        raise ValueError(f"Frame {t} out of range [0, {nt}).")
    frame_items = nx * ny * nz
    frame_bytes = frame_items * header.dtype.itemsize
    index = read_frame_index(path) if path.suffix == ".gz" else None
    if index is not None and len(index) == nt + 1:  # frame t is gzip member t + 1
        buf = _read_member(path, int(index[t]), int(index[t + 1]), frame_bytes)
    else:
        buf = _seek_read(path, header.vox_offset + t * frame_bytes, frame_bytes)
    arr = np.frombuffer(buf, dtype=header.dtype, count=frame_items).reshape((nz, ny, nx)).transpose(2, 1, 0)
    if header.scl_slope != 1.0 or header.scl_inter != 0.0:
        arr = arr.astype(np.float32) * header.scl_slope + header.scl_inter
    return np.ascontiguousarray(arr), header


def save_nifti(
    path: Union[str, Path],
    array: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
    affine: Optional[np.ndarray] = None,
    descrip: bytes = b"cinema_tpu",
    frame_indexed: bool = False,
    scl: Tuple[float, float] = (1.0, 0.0),
) -> None:
    """Write a 2-D to 4-D ``arr[x, y, ...]`` array as NIfTI-1, gzipped where the path ends in ``.gz``.

    A dtype outside ``_DTYPES`` is written as float32. ``spacing`` defaults to ones and
    ``affine`` (the sform) to ``diag(spacing)``; ``scl`` (slope, intercept) is written as given.
    ``frame_indexed`` writes a 4-D ``.nii.gz`` as one gzip member per frame with the offset table
    (module docstring), byte for byte as the JAX package writes it; it is ignored for a ``.nii``
    and for fewer dimensions.
    """
    array = np.asarray(array)
    if array.dtype not in _DTYPE_CODES:
        array = array.astype(np.float32)
    ndim = array.ndim
    if ndim < 2 or ndim > 4:
        raise ValueError(f"Only 2D-4D arrays supported, got {ndim}D.")
    spacing = tuple(float(s) for s in (spacing or (1.0,) * ndim))
    if len(spacing) != ndim:
        raise ValueError(f"Spacing rank {len(spacing)} != array rank {ndim}.")
    if affine is None:
        affine = np.eye(4)
        for i in range(min(3, ndim)):
            affine[i, i] = spacing[i]

    header = bytearray(HEADER_SIZE)
    struct.pack_into("<i", header, 0, HEADER_SIZE)
    struct.pack_into("<8h", header, 40, ndim, *array.shape, *[1] * (7 - ndim))
    struct.pack_into("<h", header, 70, _DTYPE_CODES[array.dtype])
    struct.pack_into("<h", header, 72, array.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", header, 76, 1.0, *spacing, *[1.0] * (7 - ndim))
    struct.pack_into("<f", header, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", header, 112, float(scl[0]), float(scl[1]))
    header[148 : 148 + min(len(descrip), 79)] = descrip[:79]
    struct.pack_into("<h", header, 252, 1)  # qform_code
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<12f", header, 280, *affine[:3].reshape(-1).astype(np.float32))
    header[344:348] = b"n+1\x00"
    head_payload = bytes(header) + b"\x00\x00\x00\x00"  # and the extension flag
    stored = np.ascontiguousarray(array.transpose(tuple(range(ndim - 1, -1, -1))))
    if frame_indexed and ndim == 4 and str(path).endswith(".gz"):
        nt = array.shape[-1]
        frames = [_gzip_member(stored[t].tobytes()) for t in range(nt)]  # time is the slowest axis
        # member 0's size follows from its deterministic deflate body and the table's length, so the
        # absolute offsets are known before it is written
        extra_len = 4 + 4 + 8 * (nt + 1)  # subfield id and length, u32 nt, the offsets
        base = len(_gzip_member(head_payload)) + 2 + extra_len
        offsets = np.cumsum([base] + [len(m) for m in frames]).astype("<u8")
        table = _FIDX_SI + struct.pack("<HI", 4 + 8 * (nt + 1), nt) + offsets.tobytes()
        with open(path, "wb") as f:
            f.write(_gzip_member(head_payload, extra=table))
            for m in frames:
                f.write(m)
        return
    with _open(path, "wb") as f:
        f.write(head_payload)
        f.write(stored.tobytes())


def save_nifti_like(
    array: np.ndarray,
    reference_image_path: Optional[Union[str, Path]],
    out_path: Union[str, Path],
) -> None:
    """Save ``array`` with the geometry (spacing and affine) of a reference NIfTI (port of
    cinema_tpu/data/nifti.py:367-407; reference sitk.py save_image).

    - no reference (None): a plain :func:`save_nifti`;
    - a 4-D reference and a 3-D array: the reference's first frame's geometry (rescan data);
    - sizes that differ on the last axis: both clamped to the shorter length, logged as an error
      (Kaggle studies of more than 30 frames);
    - any other size mismatch raises ValueError.
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if reference_image_path is None:
        save_nifti(out_path, array)
        return
    ref = load_nifti_header(reference_image_path)
    ref_shape = tuple(ref.shape)
    if len(ref_shape) == 4 and array.ndim == 3:
        ref_shape = ref_shape[:3]
    if ref_shape != array.shape:
        def mismatch() -> str:
            return f"Reference image {reference_image_path} has different size from the input image, " \
                   f"{ref_shape} != {array.shape}"

        logger.error(mismatch())
        n = min(ref_shape[-1], array.shape[-1])
        ref_shape, array = ref_shape[:-1] + (n,), array[..., :n]
        if ref_shape != array.shape:
            raise ValueError(mismatch())
    spacing = tuple(ref.spacing[: array.ndim])
    spacing += (1.0,) * (array.ndim - len(spacing))
    save_nifti(out_path, array, spacing=spacing, affine=ref.affine)
