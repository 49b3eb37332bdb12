"""Build the CUDA kernels in csrc/ at first use and load them with ctypes.

All of csrc/*.cu compiles with nvcc into ONE shared library with a plain C
interface (no PyTorch headers: the build takes seconds a source, and about
half a minute for temporal_conv.cu's tensor-core kernel variants), for
sm_90a (the `a` is what wgmma needs): one nvcc per source, all started
together, then one link. Nothing is linked beyond the CUDA runtime: the one
libcuda function a kernel needs (cuTensorMapEncodeTiled, for K3's TMA
descriptors) is fetched through cudaGetDriverEntryPoint.

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xcompiler -fPIC
       -Xptxas -v -c -o <name>.o csrc/<name>.cu          (each source)
  nvcc -gencode arch=compute_90a,code=sm_90a -shared
       -o libzsvc_torch_kernels.so *.o

The library lands in build/torch_kernels/<hash>/ at the root of the
checkout, keyed by a hash of the sources, the headers they share
(csrc/*.cuh) and the command, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. A file lock serialises concurrent
builds. Nothing here runs at import: the first kernel launch calls
library().

Wrappers pass every pointer and the CUDA stream as a Python int
(ctypes.c_void_p); each entry point returns cudaGetLastError(), which
launch() turns into an exception.
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

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libzsvc_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# entry point -> argtypes (every pointer and the stream are c_void_p)
SIGNATURES = {
    "zsvc_video_transform_f32": [_P] * 8 + [_I] * 9 + [_P],
    "zsvc_video_transform_bf16": [_P] * 8 + [_I] * 9 + [_P],
    "zsvc_image_motion_transform_f32": [_P] * 8 + [_F] * 6 + [_I] * 9 + [_P],
    "zsvc_image_motion_transform_bf16": [_P] * 8 + [_F] * 6 + [_I] * 9 + [_P],
    "zsvc_temporal_conv3_f32": [_P] * 3 + [_LL] + [_I] * 6 + [_P],
    "zsvc_temporal_conv3_bf16": [_P] * 4 + [_I] * 10 + [_P],
    "zsvc_bn_apply_relu_f32": [_P] * 6 + [_F, _P, _LL] + [_I] * 8 + [_P],
    "zsvc_bn_apply_relu_bf16": [_P] * 6 + [_F, _P, _LL] + [_I] * 8 + [_P],
    "zsvc_bn_bwd_f32": [_P] * 6 + [_F] + [_P] * 4 + [_LL] + [_I] * 9 + [_P],
    "zsvc_bn_bwd_bf16": [_P] * 6 + [_F] + [_P] * 4 + [_LL] + [_I] * 9 + [_P],
    "zsvc_bn_sums_f32": [_P] * 4 + [_LL] + [_I] * 7 + [_P],
    "zsvc_bn_sums_bf16": [_P] * 4 + [_LL] + [_I] * 7 + [_P],
    "zsvc_bn_sums_grad_f32": [_P] * 4 + [_LL] + [_I] * 7 + [_P],
    "zsvc_bn_sums_grad_bf16": [_P] * 4 + [_LL] + [_I] * 7 + [_P],
    "zsvc_bn_moments": [_P] * 4 + [_F] * 2 + [_P, _I, _P],
    "zsvc_bn_moments_grad": [_P] * 5 + [_I, _P],
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


def headers():
    return sorted(CSRC.glob("*.cuh"))


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
    out_dir = BUILD_ROOT / _key(srcs + headers())
    lib = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return BuildResult(lib, False, time.perf_counter() - t0, "")
            nvcc, tag = nvcc_path(), f"{os.getpid()}.tmp"
            objs = [out_dir / f".{s.stem}.{tag}.o" for s in srcs]
            tmp = out_dir / f".{LIB_NAME}.{tag}"
            try:
                cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)]
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for c in cmds]
                log = ""
                for cmd, proc in zip(cmds, procs):  # wait for every one
                    log += proc.communicate()[0]
                    if proc.returncode != 0:
                        log += (f"\nnvcc failed ({proc.returncode}): "
                                f"{' '.join(cmd)}\n")
                if any(p.returncode != 0 for p in procs):
                    raise RuntimeError(log)
                cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log += proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{log}")
                os.replace(tmp, lib)
            finally:
                for f in (*objs, tmp):
                    f.unlink(missing_ok=True)
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


def launch(fn, args, device, what: str, plan=None) -> None:
    """Call the entry point fn(*args, stream) on the current stream of
    `device` (entering the device only when it is not the current one) and
    raise if the launch failed, naming `what` and the `plan`."""
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        check(err, what if plan is None else f"{what} ({plan})")
