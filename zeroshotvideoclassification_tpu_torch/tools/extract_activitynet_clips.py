"""Offline ActivityNet preprocessing: full videos -> per-segment uint8 .npy.

The port's copy of zeroshotvideoclassification_tpu/tools/extract_activitynet_clips.py:
the same flags, outputs and messages, its imports re-pointed at the port.

Parity target: reference/auxiliary/auxiliary_activitynet.py:59-143
(__main__ block): read activity_net.v1.3.min.json, write annotations_all.csv
(one row per annotated segment), decode each video, rescale frame height to
256, cut per-segment frame ranges, save {video_id}_{k}.npy uint8 clips.
Parallelized over processes (the decode is CPU-bound C++ inside cv2/ffmpeg).

Usage:
  python -m zeroshotvideoclassification_tpu_torch.tools.extract_activitynet_clips \
      --source /data/ActivityNet/v1.3 --dest /data/ActivityNet/v1.3/clips
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing
import os
from typing import Optional


def write_annotations_csv(database: dict, dest: str) -> str:
    """annotations_all.csv: '{video_id}_{segment_idx},{label}' per segment."""
    path = os.path.join(dest, "annotations_all.csv")
    with open(path, "w") as f:
        for identity, entry in database.items():
            annos = entry.get("annotations", [])
            for k, anno in enumerate(annos):
                f.write(f"{identity}_{k},{anno['label']}\n")
    return path


def extract_one(source: str, dest: str, identity: str, entry: dict) -> Optional[int]:
    """Cut all annotated segments of one video into npy clips (height->256)."""
    import cv2
    import numpy as np

    if entry.get("subset") == "testing":
        return None
    candidates = []
    for sub in ("training", "validation"):
        candidates += glob.glob(os.path.join(source, sub, f"{identity}.*"))
    if not candidates:
        return None
    fname = candidates[0]
    annos = entry.get("annotations", [])
    if not annos:
        return None
    last = os.path.join(dest, f"{identity}_{len(annos) - 1}.npy")
    if os.path.exists(last):
        return 0

    cap = cv2.VideoCapture(fname)
    # broken containers report -1.0, which is truthy — `or` can't guard it
    fps = cap.get(cv2.CAP_PROP_FPS)
    fps = fps if fps and fps > 0 else 25.0
    segments = sorted(
        (round(a["segment"][0] * fps), round(a["segment"][1] * fps), k)
        for k, a in enumerate(annos))
    frames, count, written = [], 0, 0
    seg_i = 0
    try:
        while seg_i < len(segments):
            ok, frame = cap.read()
            if not ok:
                break
            start, end, k = segments[seg_i]
            if count >= start:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                h, w = frame.shape[:2]
                r = 256.0 / h
                frame = cv2.resize(frame, (int(r * w), 256),
                                   interpolation=cv2.INTER_LINEAR)
                frames.append(frame)
            count += 1
            if count >= end:
                if frames:
                    np.save(os.path.join(dest, f"{identity}_{k}.npy"),
                            np.stack(frames).astype("uint8"))
                    written += 1
                frames = []
                seg_i += 1
    finally:
        cap.release()
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True,
                   help="dir with activity_net.v1.3.min.json + training/ + validation/")
    p.add_argument("--dest", required=True)
    p.add_argument("--workers", type=int, default=multiprocessing.cpu_count())
    args = p.parse_args(argv)

    with open(os.path.join(args.source, "activity_net.v1.3.min.json")) as f:
        database = json.load(f)["database"]
    os.makedirs(args.dest, exist_ok=True)
    write_annotations_csv(database, args.dest)

    items = list(database.items())
    with multiprocessing.Pool(args.workers) as pool:
        pool.starmap(
            extract_one,
            [(args.source, args.dest, ident, entry) for ident, entry in items])


if __name__ == "__main__":
    main()
