"""NIfTI-1 reader and writer (port of cinema_tpu/data/nifti.py:57-133, :191-215, :284-366).

Little-endian NIfTI-1, a 348-byte header and the raw voxels, plain (``.nii``) or
gzipped (``.nii.gz``), in the eight voxel types of ``_DTYPES``, with the header's
``scl_slope`` / ``scl_inter`` scaling. Arrays use ``arr[x, y, z(, t)]`` indexing, the
transposed order of the x-fastest storage, as the JAX package's preprocessing writes
and reads them. Frame seeks, frame-indexed gzip members and the native reader of the
JAX package wait for the pretraining-on-NIfTI slice (ROADMAP.md, Queue 1, item 14).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Optional, Sequence, Tuple, Union

import numpy as np

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
        return gzip.open(path, mode)  # type: ignore[return-value]
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


def save_nifti(
    path: Union[str, Path],
    array: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
    affine: Optional[np.ndarray] = None,
    descrip: bytes = b"cinema_tpu",
    scl: Tuple[float, float] = (1.0, 0.0),
) -> None:
    """Write a 2-D to 4-D ``arr[x, y, ...]`` array as NIfTI-1, gzipped where the path ends in ``.gz``.

    A dtype outside ``_DTYPES`` is written as float32. ``spacing`` defaults to ones and
    ``affine`` (the sform) to ``diag(spacing)``; ``scl`` (slope, intercept) is written as given.
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
    with _open(path, "wb") as f:
        f.write(bytes(header) + b"\x00\x00\x00\x00")  # and the extension flag
        f.write(np.ascontiguousarray(array.transpose(tuple(range(ndim - 1, -1, -1)))).tobytes())
