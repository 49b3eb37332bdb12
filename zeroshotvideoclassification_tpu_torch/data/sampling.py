"""TSN-style clip frame selection — pure integer index math (host-side).

Parity targets:
  * video/frame-dir loaders: reference/auxiliary/auxiliary_dataset.py:173-206
  * npy clip loader:         reference/auxiliary/auxiliary_activitynet.py:34-48

The reference interleaves this arithmetic with cv2 decode loops; here it is a
pure function producing the final flat list of source-frame indices (length
n_clips * clip_len), so any decoder (cv2, the native C++ JPEG reader, or a
synthetic source) just gathers those indices. Keeping this in integer index
space on the host is what lets every device-side shape stay static.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def tsn_selection(
    total_frames: int,
    clip_len: int,
    n_clips: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Raw TSN selection: [n_snipets * clip_len] frame indices (may exceed
    total_frames; see tsn_frame_indices for the fill policy).

    Math parity with auxiliary_dataset.py:174-181:
      sampling_period = max(total // n_clips, 1)
      n_snipets       = min(n_clips, total // sampling_period)
      start per snippet: U[0, max(1, period - clip_len)) for train, 0 for val
      selection       = concat_i arange(offset_i + start_i, ... + clip_len)
    """
    assert total_frames > 0, "caller must guard zero-frame sources"
    sampling_period = max(total_frames // n_clips, 1)
    n_snipets = min(n_clips, total_frames // sampling_period)
    if not is_validation:
        rng = rng if rng is not None else np.random.default_rng()
        starts = rng.integers(0, max(1, sampling_period - clip_len), size=n_snipets)
    else:
        starts = np.zeros(n_snipets, dtype=np.int64)
    offsets = np.arange(0, total_frames, sampling_period)[:n_snipets]
    selection = np.concatenate(
        [np.arange(of + s, of + s + clip_len) for of, s in zip(offsets, starts)]
    )
    return selection.astype(np.int64)


def tsn_frame_indices(
    total_frames: int,
    clip_len: int,
    n_clips: int,
    is_validation: bool,
    rng: Optional[np.random.Generator] = None,
    fill: str = "repeat_last",
    frame_cap: Optional[int] = None,
) -> np.ndarray:
    """Final flat [n_clips * clip_len] array of in-range source-frame indices.

    fill='repeat_last': the cv2 loaders' sequential-decode semantics
      (auxiliary_dataset.py:184-206). Crucially the reference appends ONE
      frame per unique selected count (its `count not in selection` check
      fires once per decoder position), so overlapping snippet windows —
      which occur whenever total_frames < n_clips*clip_len, i.e. most videos
      under 25-clip evaluation — are DEDUPLICATED AND SORTED before frames
      are chunked into clips; out-of-range counts repeat the last decoded
      frame (ibid. :190-198); the flat list is then loop-padded from the
      front to n_clips*clip_len (ibid. :205-206).
    fill='drop': out-of-range selections are dropped (duplicates and order
      preserved — npy fancy indexing) before loop-padding (the ActivityNet
      npy loader, auxiliary_activitynet.py:43-48).
    frame_cap: optional cap on total_frames (npy loader caps at 300, ibid. :34).
    """
    frame_count = total_frames
    if frame_cap is not None:
        total_frames = min(total_frames, frame_cap)
    sel = tsn_selection(total_frames, clip_len, n_clips, is_validation, rng)

    if fill == "repeat_last":
        uniq = np.unique(sel)  # sorted unique counts, reference decode order
        out = np.empty_like(uniq)
        last = 0  # guarded: selection[0] < total_frames so frame 0 exists
        for i, s in enumerate(uniq):
            if s < frame_count:
                last = s
            out[i] = last
        sel = out
    elif fill == "drop":
        sel = sel[sel < frame_count]
        if sel.size == 0:
            sel = np.zeros(1, dtype=np.int64)
    else:
        raise ValueError(f"unknown fill policy {fill!r}")

    total = n_clips * clip_len
    while sel.shape[0] < total:  # loop-pad from the front
        sel = np.concatenate([sel, sel[: total - sel.shape[0]]])
    return sel[:total]
