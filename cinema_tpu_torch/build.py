"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled on first use into a shared library with
a plain C interface (no PyTorch headers: a build takes seconds, not minutes)
under ``build/kernels/`` at the checkout root, or ``$CINEMA_TORCH_BUILD_DIR``.
The file name carries a hash of the source, the shared headers and the
flags, so an edited kernel is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# kernel name -> source file in csrc/
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",  # the forward of both layouts
    "flash_attention_bwd": "flash_attention_bwd.cu",  # the backward of both layouts
    "depthwise_conv": "depthwise_conv.cu",  # the stems' depthwise 5^nd convolution, forward and gradients
}
# headers the sources include: hashed into every library's name
HEADERS = ("flash_attention_common.cuh", "hopper.cuh", "tf32.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
build_logs: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("CINEMA_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed.")
    return found


def library_path(name: str) -> Path:
    files = [CSRC / SOURCES[name], *(CSRC / h for h in HEADERS)]
    content = b"".join(f.read_bytes() for f in files)
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named kernels (all by default), one nvcc each, all at once.

    Returns seconds per kernel (0.0 where the library was already built).
    Raises with nvcc's output if any build fails.
    """
    names = list(SOURCES) if names is None else names
    build_dir().mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]
