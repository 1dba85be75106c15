"""The port's C++ NIfTI frame reader (``cinema_tpu_torch.native``) against the JAX package's
(``cinema_tpu.native``) and against the Python reads of both packages: headers, frames of every voxel
type from ``.nii``, single-member ``.nii.gz`` and frame-indexed ``.nii.gz``, the threaded batch read,
the error codes, ``CINEMA_TORCH_NATIVE`` (0: Python, 1: the native reader required), a failed build,
and two processes that build at once."""

import logging
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from cinema_tpu import native as jax_native
from cinema_tpu.data import nifti as jax_nifti
from cinema_tpu_torch import native
from cinema_tpu_torch.data import nifti

REPO = Path(__file__).resolve().parents[1]
DTYPES = [np.dtype(d) for d in native._DTYPES.values()]
LAYOUTS = ["nii", "nii.gz", "indexed"]


@pytest.fixture(scope="module", autouse=True)
def native_reader():
    assert native.reader() == "native", native.build_info
    assert Path(native.build_info["library"]) == native.library_path()


@pytest.fixture
def logged():
    """The messages that the port's NIfTI reader and native module log during the test."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    loggers = [logging.getLogger(name) for name in ("cinema_tpu_torch.data.nifti", "cinema_tpu_torch.native")]
    for logger in loggers:
        logger.addHandler(handler)
    yield records
    for logger in loggers:
        logger.removeHandler(handler)


def _python_reader(monkeypatch):
    """The Python reads of the port: the native functions return None."""
    monkeypatch.setattr(native, "_lib", None)


def _cine(dtype, shape=(7, 6, 5, 4), seed=0):
    rng = np.random.default_rng(seed)
    if dtype.kind == "f":
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), size=shape, endpoint=True).astype(dtype)


def _write(tmp_path, dtype, layout, seed=0):
    arr = _cine(dtype, seed=seed)
    path = tmp_path / f"cine_{dtype.name}_{layout.replace('.', '_')}.{'nii' if layout == 'nii' else 'nii.gz'}"
    nifti.save_nifti(path, arr, spacing=(1.5, 1.5, 8.0, 1.0), frame_indexed=layout == "indexed")
    assert (nifti.read_frame_index(path) is not None) == (layout == "indexed")
    return path, arr


def test_dtypes_are_the_jax_readers_and_the_python_readers():
    assert native._DTYPES == jax_native._DTYPES == nifti._DTYPES


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_probe_matches_the_header_and_the_jax_probe(tmp_path, dtype, layout):
    path, arr = _write(tmp_path, dtype, layout)
    got = native.probe(path)
    header = nifti.load_nifti_header(path)
    assert got == jax_native.probe(path)
    assert got == (arr.shape, dtype, header.vox_offset, header.scl_slope, header.scl_inter)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_frames_are_byte_equal_across_readers_and_packages(tmp_path, monkeypatch, dtype, layout):
    path, arr = _write(tmp_path, dtype, layout, seed=1)
    nt = arr.shape[-1]
    frames = [nifti.load_nifti_frame(path, t)[0] for t in range(nt)]
    jax_frames = [jax_nifti.load_nifti_frame(path, t)[0] for t in range(nt)]
    with monkeypatch.context() as m:
        _python_reader(m)
        assert native.read_at(path, 352, 4) is None and native.inflate_at(path, 0, 4, 4) is None
        python_frames = [nifti.load_nifti_frame(path, t)[0] for t in range(nt)]
    with monkeypatch.context() as m:
        m.setattr(jax_native, "read_at", lambda *a, **k: None)
        m.setattr(jax_native, "inflate_at", lambda *a, **k: None)
        jax_python_frames = [jax_nifti.load_nifti_frame(path, t)[0] for t in range(nt)]
    for t in range(nt):
        for other in (python_frames[t], jax_frames[t], jax_python_frames[t], arr[..., t]):
            assert frames[t].dtype == other.dtype and frames[t].tobytes() == other.tobytes()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_raw_reads_are_the_jax_readers(tmp_path, layout):
    path, arr = _write(tmp_path, np.dtype(np.int16), layout, seed=2)
    frame_bytes = arr[..., 0].nbytes
    header = nifti.load_nifti_header(path)
    for t in range(arr.shape[-1]):
        offset = header.vox_offset + t * frame_bytes
        got = native.read_at(path, offset, frame_bytes)
        assert got.tobytes() == jax_native.read_at(path, offset, frame_bytes).tobytes()
        assert got.tobytes() == np.ascontiguousarray(arr[..., t].T).tobytes()
    if layout == "indexed":
        index = nifti.read_frame_index(path)
        for t in range(arr.shape[-1]):
            start, clen = int(index[t]), int(index[t + 1] - index[t])
            got = native.inflate_at(path, start, clen, frame_bytes)
            assert got.tobytes() == jax_native.inflate_at(path, start, clen, frame_bytes).tobytes()
            with open(path, "rb") as f:
                f.seek(start)
                assert got.tobytes() == zlib.decompressobj(wbits=31).decompress(f.read(clen))


def test_read_at_batch_with_three_threads(tmp_path):
    items, want = [], []
    for i in range(7):
        dtype = DTYPES[i % len(DTYPES)]
        path, arr = _write(tmp_path, dtype, LAYOUTS[i % 3], seed=10 + i)
        t = i % arr.shape[-1]
        frame_bytes = arr[..., 0].nbytes
        items.append((str(path), nifti.load_nifti_header(path).vox_offset + t * frame_bytes, frame_bytes))
        want.append(np.ascontiguousarray(arr[..., t].T).tobytes())
    got = native.read_at_batch(items, n_threads=3)
    jax_got = jax_native.read_at_batch(items, n_threads=3)
    assert [b.tobytes() for b in got] == [b.tobytes() for b in jax_got] == want
    assert native.read_at_batch([], n_threads=3) == []


def test_error_codes_are_the_jax_readers(tmp_path):
    path, arr = _write(tmp_path, np.dtype(np.uint8), "nii.gz")
    bad = tmp_path / "not_nifti.nii"
    bad.write_bytes(b"\0" * 400)
    short = tmp_path / "short.nii"
    short.write_bytes(b"\0" * 100)
    calls = [
        ("probe", (tmp_path / "missing.nii.gz",), "code 1"),  # CT_ERR_OPEN
        ("probe", (short,), "code 2"),  # CT_ERR_READ: no 348-byte header
        ("probe", (bad,), "code 3"),  # CT_ERR_MAGIC
        ("read_at", (path, 352, arr.nbytes + 1), "code 2"),  # past the end of the stream
        ("read_at", (tmp_path / "missing.nii", 0, 4), "code 1"),
        ("inflate_at", (path, 0, 64, 16), "code 2"),  # not a whole member
        ("inflate_at", (tmp_path / "missing.nii.gz", 0, 4, 4), "code 1"),
    ]
    for name, args, code in calls:
        for module in (native, jax_native):
            with pytest.raises(IOError, match=code):
                getattr(module, name)(*args)
    with pytest.raises(IOError, match="code 1"):
        native.read_at_batch([(str(path), 352, 4), (str(tmp_path / "missing.nii"), 0, 4)], n_threads=3)


def test_a_stream_the_native_reader_refuses_is_read_with_python_and_logged(tmp_path, monkeypatch, logged):
    path, arr = _write(tmp_path, np.dtype(np.float32), "indexed", seed=3)

    def refuse(*args):
        raise IOError("refused")

    monkeypatch.setattr(native, "inflate_at", refuse)
    monkeypatch.setattr(native, "read_at", refuse)
    frame, _ = nifti.load_nifti_frame(path, 2)
    assert frame.tobytes() == arr[..., 2].tobytes()
    assert any("native frame read failed (refused)" in m for m in logged), logged


def test_a_refused_stream_raises_where_the_native_reader_is_required(tmp_path, monkeypatch, logged):
    path, arr = _write(tmp_path, np.dtype(np.float32), "nii.gz", seed=4)
    monkeypatch.setenv("CINEMA_TORCH_NATIVE", "1")
    assert native.required()
    assert np.array_equal(nifti.load_nifti_frame(path, 1)[0], arr[..., 1])

    def refuse(*args):
        raise IOError("refused")

    monkeypatch.setattr(native, "read_at", refuse)
    with pytest.raises(IOError, match="refused"):
        nifti.load_nifti_frame(path, 1)
    assert not logged


_BUILD_AND_READ = """
import sys
from cinema_tpu_torch import native
from cinema_tpu_torch.data import nifti
print(native.reader(), nifti.load_nifti_frame(sys.argv[1], 1)[0].sum())
"""


def test_two_processes_that_build_at_once_leave_one_library(tmp_path):
    path, arr = _write(tmp_path, np.dtype(np.uint16), "indexed", seed=5)
    build_dir = tmp_path / "build"
    env = {**os.environ, "CINEMA_TORCH_BUILD_DIR": str(build_dir), "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_READ, str(path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "NIfTI frame reader: native" in out and out.splitlines()[-1] == f"native {arr[..., 1].sum()}", out
    assert sorted(f.name for f in build_dir.iterdir()) == [native.library_path().name]

    env["CINEMA_TORCH_NATIVE"] = "0"
    out = subprocess.run([sys.executable, "-c", _BUILD_AND_READ, str(path)], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert "NIfTI frame reader: python (CINEMA_TORCH_NATIVE=0)" in out
    assert out.splitlines()[-1] == f"python {arr[..., 1].sum()}"


def test_a_failed_build_is_logged_with_the_compilers_output(tmp_path, monkeypatch, logged):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_loaded", False)
    monkeypatch.setattr(native, "build_info", {})
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("int ct_probe( {\n")
    monkeypatch.setenv("CINEMA_TORCH_BUILD_DIR", str(tmp_path / "build"))
    assert native.reader() == "python"
    assert len(logged) == 1 and "NIfTI frame reader: python; the native reader did not build or load" in logged[0]
    assert "broken.cpp" in logged[0] and "error" in logged[0]


def test_a_failed_build_raises_where_the_native_reader_is_required(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_loaded", False)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("int ct_probe( {\n")
    monkeypatch.setenv("CINEMA_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CINEMA_TORCH_NATIVE", "1")
    with pytest.raises(RuntimeError, match="CINEMA_TORCH_NATIVE=1 but the native reader did not build"):
        native.reader()
    assert not native._loaded
