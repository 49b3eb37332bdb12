"""ctypes binding for the native threaded JPEG batch decoder (native/).

Falls back gracefully: `available()` is False when the shared library has not
been built (`make -C native`), and data/decode.py then uses cv2.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libzsvc_decode.so"),
    "libzsvc_decode.so",
)

_lib = None
_threads = max((os.cpu_count() or 1), 1)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.sep in p else p)
            lib.zsvc_decode_jpeg_batch.restype = ctypes.c_int
            lib.zsvc_decode_jpeg_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.zsvc_jpeg_dims.restype = ctypes.c_int
            lib.zsvc_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            # DCT-scaled entry points; absent from a pre-rebuild .so, in
            # which case scale_denom>1 requests quietly decode at full size
            # (the callers treat scaling as an optimization hint only)
            try:
                lib.zsvc_decode_jpeg_batch_scaled.restype = ctypes.c_int
                lib.zsvc_decode_jpeg_batch_scaled.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
                lib.zsvc_jpeg_dims_scaled.restype = ctypes.c_int
                lib.zsvc_jpeg_dims_scaled.argtypes = [
                    ctypes.c_char_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ]
                lib._zsvc_has_scaled = True
            except AttributeError:
                lib._zsvc_has_scaled = False
            _lib = lib
            return _lib
        except OSError:
            continue
    _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def set_threads(n: int) -> None:
    global _threads
    _threads = max(int(n), 1)


def jpeg_dims(path: str, scale_denom: int = 1) -> Optional[Tuple[int, int]]:
    """(h, w) a decode at 1/scale_denom would emit (= ceil(dim/denom))."""
    lib = _load()
    if not lib:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if scale_denom > 1 and getattr(lib, "_zsvc_has_scaled", False):
        rc = lib.zsvc_jpeg_dims_scaled(path.encode(), int(scale_denom),
                                       ctypes.byref(h), ctypes.byref(w))
    else:
        rc = lib.zsvc_jpeg_dims(path.encode(), ctypes.byref(h),
                                ctypes.byref(w))
    if rc != 0:
        return None
    return h.value, w.value


def has_scaled_decode() -> bool:
    lib = _load()
    return bool(lib) and getattr(lib, "_zsvc_has_scaled", False)


def decode_jpeg_batch(paths: List[str],
                      scale_denom: int = 1) -> Optional[np.ndarray]:
    """-> [n, h, w, 3] RGB uint8, or None on failure (caller falls back).

    scale_denom in {1, 2, 4, 8} selects libjpeg's DCT-domain scaled decode;
    a library built before the scaled entry points existed ignores it."""
    lib = _load()
    if not lib or not paths:
        return None
    if scale_denom > 1 and not getattr(lib, "_zsvc_has_scaled", False):
        scale_denom = 1
    dims = jpeg_dims(paths[0], scale_denom)
    if dims is None:
        return None
    h, w = dims
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if scale_denom > 1:
        n_ok = lib.zsvc_decode_jpeg_batch_scaled(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            h, w, _threads, int(scale_denom))
    else:
        n_ok = lib.zsvc_decode_jpeg_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            h, w, _threads)
    if n_ok == 0:
        return None
    return out


# ---------------------------------------------------------------- video -----
# libzsvc_video.so: libavformat/libavcodec sequential gatherer (GIL-free) —
# the 'video' loader's analog of the JPEG pool above. Separate library so a
# host without libav still gets the JPEG path (decode.py falls back to cv2).

_VIDEO_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libzsvc_video.so"),
    "libzsvc_video.so",
)

_video_lib = None


def _load_video():
    global _video_lib
    if _video_lib is not None:
        return _video_lib
    for p in _VIDEO_LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.sep in p else p)
            lib.zsvc_video_probe.restype = ctypes.c_int
            lib.zsvc_video_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.zsvc_video_gather.restype = ctypes.c_int
            lib.zsvc_video_gather.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            _video_lib = lib
            return _video_lib
        except OSError:
            continue
    _video_lib = False
    return _video_lib


def video_available() -> bool:
    return bool(_load_video())


def video_probe(path: str) -> Optional[Tuple[int, int, int]]:
    """-> (frame_count, h, w) from container metadata (cv2
    CAP_PROP_FRAME_COUNT analog), or None when the container is unreadable."""
    lib = _load_video()
    if not lib:
        return None
    n = ctypes.c_long()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.zsvc_video_probe(path.encode(), ctypes.byref(n), ctypes.byref(h),
                            ctypes.byref(w)) != 0:
        return None
    return int(n.value), h.value, w.value


def video_gather(path: str, idx, h: int, w: int) -> Optional[np.ndarray]:
    """Gather frames at (possibly repeated, unsorted) display indices `idx`
    with the decode.py::decode_video fill semantics: frames that failed to
    decode repeat the previously GATHERED frame (first decoded frame when the
    gather starts on a hole); None when nothing decoded."""
    lib = _load_video()
    if not lib:
        return None
    idx = np.asarray(idx, np.int64)
    uniq = np.unique(idx)  # sorted ascending
    n_u = len(uniq)
    rows = np.empty((n_u, h, w, 3), np.uint8)
    ok = np.zeros(n_u, np.uint8)
    n_ok = lib.zsvc_video_gather(
        path.encode(),
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_u,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if n_ok <= 0:
        return None
    pos = {int(u): i for i, u in enumerate(uniq)}
    first_ok = rows[int(np.argmax(ok))]
    out, last = [], None
    for i in idx:
        r = pos[int(i)]
        f = rows[r] if ok[r] else (last if last is not None else first_ok)
        out.append(f)
        last = f
    return np.stack(out)
