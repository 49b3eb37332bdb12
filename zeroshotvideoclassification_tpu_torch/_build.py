"""Build the CUDA kernels in csrc/ at first use and load them with ctypes.

All of csrc/*.cu compiles with nvcc into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), for sm_90a:

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
       -Xcompiler -fPIC -o libzsvc_torch_kernels.so csrc/*.cu

The library lands in build/torch_kernels/<hash>/ at the root of the
checkout, keyed by a hash of the sources and the command, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. A file lock
serialises concurrent builds. Nothing here runs at import: the first
kernel launch calls library().

Wrappers pass every pointer and the CUDA stream as a Python int
(ctypes.c_void_p); each entry point returns cudaGetLastError().
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libzsvc_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry point -> argtypes (every pointer and the stream are c_void_p)
SIGNATURES = {
    "zsvc_video_transform_f32": [_P] * 8 + [_I] * 5 + [_P],
    "zsvc_video_transform_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "zsvc_bn_apply_relu_f32": [_P] * 5 + [_LL, _I, _I, _P],
    "zsvc_bn_apply_relu_bf16": [_P] * 5 + [_LL, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass
class BuildResult:
    """Where the library is, whether this call compiled it, how long the
    call took, and what nvcc printed (its -Xptxas -v register report)."""

    path: Path
    compiled: bool
    seconds: float
    log: str


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile csrc/*.cu unless a library of the same hash exists."""
    t0 = time.perf_counter()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = BUILD_ROOT / _key(srcs)
    lib = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return BuildResult(lib, False, time.perf_counter() - t0, "")
            tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, lib)
            return BuildResult(lib, True, time.perf_counter() - t0, log)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
