"""Host-side decode: JPEG frame dirs, video files, npy clips -> uint8 frames.

Decode stays on the host by design (BASELINE.json): the device only ever sees
the packed uint8 canvas. Three loader kinds mirror the reference:
  * frame_dir: JPEG directories `fname/images/img_%05d.jpg`
    (reference/auxiliary/auxiliary_dataset.py:211-266) — the ACTIVE path
  * video: cv2.VideoCapture sequential decode (ibid. :158-208)
  * npy: np.load(mmap_mode='r') pre-cut ActivityNet clips
    (reference/auxiliary/auxiliary_activitynet.py:22-50)

Each returns (frames [n_clips*clip_len, h, w, 3] RGB uint8, ok: bool); any
failure returns ok=False and the caller emits a weight-0 sample (the
reference's label==-1 noise convention). The native C++ libjpeg decoder
(native/) plugs in behind decode_frame_dir when built.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from zeroshotvideoclassification_tpu_torch.data.sampling import tsn_frame_indices

try:  # optional; the synthetic pipeline and npy path work without it
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

_native = None


def _get_native():
    global _native
    if _native is None:
        try:
            from zeroshotvideoclassification_tpu_torch.data import native_decode
            _native = native_decode if native_decode.available() else False
        except Exception:
            _native = False
    return _native


def pick_decode_denom(full_hw: Tuple[int, int], scale_cap: int,
                      min_short_side: int) -> int:
    """Largest DCT-scale denominator d in {1,2,4,8}, d <= scale_cap, whose
    scaled short side (ceil(min(h,w)/d)) still covers `min_short_side` — so
    the device resize that follows only ever downsamples, never upsamples.
    A source already at/below the resize target decodes at full size."""
    short = min(int(full_hw[0]), int(full_hw[1]))
    for d in (8, 4, 2):
        if d <= scale_cap and -(-short // d) >= min_short_side:
            return d
    return 1


def decode_frame_dir(
    fname: str,
    clip_len: int,
    n_clips: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
    scale_cap: int = 1,
    min_short_side: int = 0,
) -> Tuple[Optional[np.ndarray], bool]:
    """JPEG frame directory -> sampled frames (the active training path).

    scale_cap > 1 opts into libjpeg DCT-domain scaled decode (an input-
    pipeline throughput lever, Config.decode_scale): frames whose short side
    would still cover `min_short_side` after scaling decode directly at
    1/2, 1/4 or 1/8 size — ~4x less IDCT work and 4x fewer H2D bytes per
    halving. Numerics differ from full-decode-then-device-resize (the
    reference's path, auxiliary_dataset.py:211-266 + transforms.py:99-107),
    so the default (1) keeps exact parity; requires the native decoder
    (the cv2 fallback decodes at full size regardless)."""
    images_dir = os.path.join(fname, "images")
    if not os.path.isdir(images_dir):
        return None, False
    frame_count = len(glob.glob(os.path.join(images_dir, "*")))
    if frame_count == 0:
        return None, False
    idx = tsn_frame_indices(frame_count, clip_len, n_clips, is_validation, rng)
    paths = [os.path.join(images_dir, "img_%05d.jpg" % (i + 1)) for i in idx]

    native = _get_native()
    if native:
        denom = 1
        if scale_cap > 1 and min_short_side > 0 and native.has_scaled_decode():
            full_hw = native.jpeg_dims(paths[0])
            if full_hw is not None:
                denom = pick_decode_denom(full_hw, scale_cap, min_short_side)
        frames = native.decode_jpeg_batch(paths, scale_denom=denom)
        if frames is not None:
            return frames, True

    if cv2 is None:
        return None, False
    # Corrupt-frame divergence from the reference (deliberate, corrupt-data
    # only): `paths` is in GATHER order and may be loop-padded/non-monotonic,
    # so repeating the previous gathered frame can substitute a temporally
    # LATER frame than the reference's sequential repeat-last
    # (auxiliary_dataset.py:253-258); a broken FIRST frame aborts the whole
    # sample (-> weight-0) where the reference substituted noise frames.
    frames = []
    for p in paths:
        img = cv2.imread(p)
        if img is not None and frames and img.shape != frames[0].shape:
            # dims-mismatched frame (re-encoded/corrupt dataset entry):
            # treat like a failed decode — np.stack would otherwise raise
            # and abort the whole run instead of honoring the weight-0
            # contract; the native libjpeg path repeat-fills the same way
            img = None
        if img is None:
            if not frames:
                return None, False
            img = frames[-1].copy()
            frames.append(img)
            continue
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(frames), True


def decode_video(
    fname: str,
    clip_len: int,
    n_clips: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Optional[np.ndarray], bool]:
    """Sequential encoded-video decode with repeat-last fill for bad frames.

    Prefers the native libav gatherer (native/zsvc_video.cpp — GIL-free like
    the frame-dir path's libjpeg pool; same probe/fill semantics as the cv2
    code below, parity-tested in tests/test_decode_video.py), falling back
    to cv2 when the library is absent. The TSN indices are drawn ONCE (the
    fallback reuses them, so the rng stream is identical either way).
    ZSVC_NATIVE_VIDEO=0 forces cv2."""
    if not os.path.exists(fname):
        return None, False
    native = None
    if os.environ.get("ZSVC_NATIVE_VIDEO", "1") != "0":
        try:
            from zeroshotvideoclassification_tpu_torch.data import native_decode
            if native_decode.video_available():
                native = native_decode
        except Exception:  # pragma: no cover
            native = None

    frame_count = h = w = 0
    if native is not None:
        meta = native.video_probe(fname)
        if meta is not None:
            frame_count, h, w = meta
        else:
            native = None  # unreadable by libav: let cv2 have a look
    if native is None:
        if cv2 is None:
            return None, False
        cap = cv2.VideoCapture(fname)
        frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
    # unreadable containers report -1 (and isOpened() False); anything
    # non-positive must take the broken-sample path, not reach the TSN
    # index math (auxiliary_dataset.py:168-171 skip semantics)
    if frame_count <= 0 or w <= 0 or h <= 0:
        return None, False
    idx = tsn_frame_indices(frame_count, clip_len, n_clips, is_validation, rng)

    if native is not None:
        frames = native.video_gather(fname, idx, h, w)
        if frames is not None:
            return frames, True
        # gather found nothing decodable: same verdict as the cv2 loop
        # below would reach on this container, but let it confirm

    return _cv2_video_gather(fname, idx)


def _cv2_video_gather(fname, idx) -> Tuple[Optional[np.ndarray], bool]:
    """Sequential cv2 read of precomputed display indices, repeat-last fill
    (auxiliary_dataset.py:173-205 semantics)."""
    if cv2 is None:
        return None, False
    cap = cv2.VideoCapture(fname)
    try:
        wanted = set(int(i) for i in idx)
        decoded = {}
        for pos in range(max(wanted) + 1):
            ok, frame = cap.read()
            if not ok:
                break
            if pos in wanted:
                decoded[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if not decoded:
            return None, False
        out, last = [], None
        for i in idx:
            f = decoded.get(int(i))
            if f is None:
                f = last if last is not None else next(iter(decoded.values()))
            out.append(f)
            last = f
        return np.stack(out), True
    finally:
        cap.release()


def decode_npy(
    fname: str,
    clip_len: int,
    n_clips: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Optional[np.ndarray], bool]:
    """Pre-cut ActivityNet clip: mmap gather with the 'drop' fill + 300 cap."""
    if not os.path.exists(fname):
        return None, False
    try:
        clip = np.load(fname, mmap_mode="r")
    except ValueError:
        return None, False
    frame_count = clip.shape[0]
    if frame_count == 0:
        return None, False
    idx = tsn_frame_indices(
        frame_count, clip_len, n_clips, is_validation, rng,
        fill="drop", frame_cap=300)
    return np.ascontiguousarray(clip[idx]), True


def detect_loader(path: str) -> str:
    """frame_dir | npy | video, by filesystem shape then content.

    The magic-byte sniff keeps detection correct for paths whose name lost
    its extension — e.g. the serving trust model decodes the REALPATH of a
    request (serve/server.py admit()), and an in-root `clip.npy` symlink may
    resolve to an extensionless blob-store file."""
    if os.path.isdir(path):
        return "frame_dir"
    if path.endswith(".npy"):
        return "npy"
    try:
        with open(path, "rb") as f:
            if f.read(6) == b"\x93NUMPY":
                return "npy"
    except OSError:
        pass
    return "video"


def decode_auto(path, clip_len, n_clips, is_validation, rng,
                scale_cap: int = 1, min_short_side: int = 0):
    """Per-path loader dispatch: lets one VideoTable (hence ONE padded device
    dispatch) mix frame-dir, encoded-video and .npy sources — the serving
    engine's mixed-request path uses this so a 3-kind request costs one
    forward instead of three max_batch-padded ones. The DCT-scale hint
    applies only to the JPEG frame-dir kind."""
    kind = detect_loader(path)
    if kind == "frame_dir" and scale_cap > 1:
        return decode_frame_dir(path, clip_len, n_clips, is_validation, rng,
                                scale_cap=scale_cap,
                                min_short_side=min_short_side)
    return DECODERS[kind](path, clip_len, n_clips, is_validation, rng)


DECODERS = {
    "frame_dir": decode_frame_dir,
    "video": decode_video,
    "npy": decode_npy,
}
DECODERS["auto"] = decode_auto
