"""The C++ NIfTI frame reader, loaded with ctypes (port of cinema_tpu/native).

``frame_reader.cpp`` probes NIfTI headers and reads frames, inflating gzip in
C++ with zlib while the interpreter runs on (ctypes releases its lock around
a call); ``read_at_batch`` reads many frames on threads of its own.
``data.nifti`` reads frames through it where it runs.

Build: at first use, never at import, ``g++ -O2 -shared -fPIC -std=c++17 ...
-lz -lpthread`` compiles the source into ``build.build_dir()`` (``build/kernels/``
of the checkout, git-ignored, or ``$CINEMA_TORCH_BUILD_DIR``), under a name that
carries a hash of the source and the flags. The compiler writes a temporary file
that is then renamed into place, so loader processes that build at once never
load a partial library.

Which reader runs: :func:`reader` says ``"native"`` or ``"python"``. The first
use logs which one and, where the build failed, the compiler's output.
``CINEMA_TORCH_NATIVE=0`` keeps the Python reader; ``CINEMA_TORCH_NATIVE=1``
requires the native one (:func:`required`): a failed build raises, and so does a
stream that it refuses, where by default the frame is read with Python and the
refusal logged. Where the Python reader runs, :func:`probe`, :func:`read_at`,
:func:`inflate_at` and :func:`read_at_batch` return None and the caller reads
with Python; both readers give the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cinema_tpu_torch import build as _build_dirs
from cinema_tpu_torch.log import get_logger

SOURCE = Path(__file__).resolve().parent / "frame_reader.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

# NIfTI datatype code -> numpy dtype (data/nifti.py's _DTYPES)
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

logger = get_logger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_loaded = False
# the library's path and the seconds that the first use took (the build where the library was not there yet)
build_info: dict = {}


class CtNiftiHeader(ctypes.Structure):
    _fields_ = [
        ("ndim", ctypes.c_int64),
        ("shape", ctypes.c_int64 * 7),
        ("datatype", ctypes.c_int32),
        ("bitpix", ctypes.c_int32),
        ("vox_offset", ctypes.c_int64),
        ("scl_slope", ctypes.c_float),
        ("scl_inter", ctypes.c_float),
    ]


def library_path(out_dir: Optional[Path] = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((*FLAGS, *LIBS)).encode()).hexdigest()[:12]
    return (out_dir or _build_dirs.build_dir()) / f"frame_reader-{digest}.so"


def build(out_dir: Optional[Path] = None, compiler: str = "g++") -> Path:
    """Compile the reader (if its library is not there yet) and return the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    out = library_path(out_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="frame_reader-", suffix=".so.tmp", dir=out.parent)
    os.close(fd)
    cmd = [compiler, *FLAGS, str(SOURCE), "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)  # atomic: a process that builds at the same time loads one or the other, whole
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(path: Path) -> ctypes.CDLL:
    """Load a built reader and declare its functions."""
    lib = ctypes.CDLL(str(path))
    lib.ct_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(CtNiftiHeader)]
    lib.ct_probe.restype = ctypes.c_int
    lib.ct_read_at.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_ubyte)]
    lib.ct_read_at.restype = ctypes.c_int
    lib.ct_inflate_at.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.c_int64]
    lib.ct_inflate_at.restype = ctypes.c_int
    lib.ct_read_at_batch.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_int64,
    ]
    lib.ct_read_at_batch.restype = ctypes.c_int
    return lib


def required() -> bool:
    """``CINEMA_TORCH_NATIVE=1``: the native reader must run, and a read that it refuses raises."""
    return os.environ.get("CINEMA_TORCH_NATIVE") == "1"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _loaded
    if _loaded:
        return _lib
    with _lock:
        if _loaded:
            return _lib
        if os.environ.get("CINEMA_TORCH_NATIVE") == "0":
            logger.info("NIfTI frame reader: python (CINEMA_TORCH_NATIVE=0)")
        else:
            try:
                t0 = time.perf_counter()
                path = build()
                _lib = load_library(path)
                build_info.update(library=str(path), load_s=time.perf_counter() - t0)
                logger.info(f"NIfTI frame reader: native ({build_info})")
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                if required():
                    raise RuntimeError(f"CINEMA_TORCH_NATIVE=1 but the native reader did not build or load: {e}")
                logger.warning(f"NIfTI frame reader: python; the native reader did not build or load: {e}")
        _loaded = True
    return _lib


def reader() -> str:
    """``"native"`` where the C++ reader built and loaded, else ``"python"``."""
    return "native" if _load() is not None else "python"


def available() -> bool:
    """True when the native reader runs."""
    return _load() is not None


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def probe(path) -> Optional[Tuple[Tuple[int, ...], np.dtype, int, float, float]]:
    """The header natively: (shape, dtype, vox_offset, scl_slope, scl_inter), or None where Python reads."""
    lib = _load()
    if lib is None:
        return None
    hdr = CtNiftiHeader()
    rc = lib.ct_probe(str(path).encode(), ctypes.byref(hdr))
    if rc != 0:
        raise IOError(f"ct_probe({path}) failed with code {rc}.")
    if hdr.datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype {hdr.datatype} in {path}.")
    shape = tuple(int(hdr.shape[i]) for i in range(int(hdr.ndim)))
    slope = float(hdr.scl_slope) if hdr.scl_slope != 0.0 else 1.0
    return shape, _DTYPES[hdr.datatype], int(hdr.vox_offset), slope, float(hdr.scl_inter)


def read_at(path, offset: int, nbytes: int) -> Optional[np.ndarray]:
    """``nbytes`` of the voxel stream from ``offset`` (gzip or raw) as uint8, or None where Python reads."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(nbytes, dtype=np.uint8)
    rc = lib.ct_read_at(str(path).encode(), offset, nbytes, _ptr(buf))
    if rc != 0:
        raise IOError(f"ct_read_at({path}, {offset}, {nbytes}) failed with code {rc}.")
    return buf


def inflate_at(path, offset: int, clen: int, nbytes: int) -> Optional[np.ndarray]:
    """The gzip member at the byte range [offset, offset + clen), inflated to ``nbytes`` (a frame of a
    frame-indexed ``.nii.gz``), as uint8, or None where Python reads."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(nbytes, dtype=np.uint8)
    rc = lib.ct_inflate_at(str(path).encode(), offset, clen, _ptr(buf), nbytes)
    if rc != 0:
        raise IOError(f"ct_inflate_at({path}, {offset}, {clen}) failed with code {rc}.")
    return buf


def read_at_batch(items: Sequence[Tuple[str, int, int]], n_threads: int = 0) -> Optional[List[np.ndarray]]:
    """Many (path, offset, nbytes) reads on ``n_threads`` C++ threads (0: one per item, at most the CPU
    count), the interpreter free for the whole batch; uint8 buffers in order, or None where Python reads."""
    lib = _load()
    if lib is None:
        return None
    n = len(items)
    if n == 0:
        return []
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    bufs = [np.empty(nb, dtype=np.uint8) for _, _, nb in items]
    paths = (ctypes.c_char_p * n)(*[str(p).encode() for p, _, _ in items])
    offsets = (ctypes.c_int64 * n)(*[o for _, o, _ in items])
    nbytes = (ctypes.c_int64 * n)(*[nb for _, _, nb in items])
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)(*[_ptr(b) for b in bufs])
    rc = lib.ct_read_at_batch(n, paths, offsets, nbytes, outs, n_threads)
    if rc != 0:
        raise IOError(f"ct_read_at_batch failed with code {rc}.")
    return bufs
