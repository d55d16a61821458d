"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``csrc/build/<name>-<hash>.so`` for ``sm_90a``, where ``<hash>``
is a digest of the source, the shared headers and the flags, so an edited
source is never served by a stale library.  Nothing here runs at import time: a library
is built the first time a wrapper launches one of its kernels (or by
:func:`build_all`, which starts one ``nvcc`` per source at once).

Calling convention shared by every entry point: each pointer argument
and the CUDA stream are ``ctypes.c_void_p``, and the function returns
``cudaGetLastError()`` after its launch (or a negative code of its own),
which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built
# by this process, keyed by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the job."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    build_logs[name] = log


def build_all(names: Iterable[str]) -> None:
    """Build every named library, all nvcc processes started together."""
    errors: List[str] = []
    with _lock:
        jobs: List = []
        try:
            for n in names:
                jobs.append((n, _start(n)))
        finally:
            for n, job in jobs:   # wait for every nvcc, even after a failure
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry point returns an ``int`` (the launch's ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


# the port's own negative status codes (no cudaError_t is negative)
_PORT_ERRORS = {-1: "cuTensorMapEncodeTiled could not encode a TMA tensor map"}


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t`` or one
    of the port's own negative codes."""
    if status in _PORT_ERRORS:
        raise RuntimeError(f"{what}: {_PORT_ERRORS[status]} at launch")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_aligned(what: str, *tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary (the
    kernels move data in 16-byte vectors)."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data must be 16-byte aligned")


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a ctypes argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
F32 = ctypes.c_float
