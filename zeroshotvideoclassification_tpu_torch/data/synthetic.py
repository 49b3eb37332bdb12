"""Synthetic class-conditional video source (tests / bench / smoke runs).

Renders deterministic procedural videos whose visual parameters are a linear
function of the class embedding: class c has latent theta_c in R^4 (center x/y
drift, size, color phase); frames show a moving bright square with those
parameters, and the class embedding is normalize(W @ theta_c) for a fixed
seeded W. A regression model can therefore genuinely learn video -> embedding
and generalize to UNSEEN synthetic classes — giving the full zero-shot
pipeline (train on one class set, eval on a disjoint set) a learnable,
dataset-free end-to-end testbed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
from zeroshotvideoclassification_tpu_torch.data.sampling import tsn_frame_indices

_EMBED_DIM = 300
_THETA_DIM = 4


def _class_theta(class_id: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + class_id)
    return rng.uniform(0.2, 0.8, size=_THETA_DIM).astype(np.float32)


def _embedding_map() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.normal(size=(_EMBED_DIM, _THETA_DIM)).astype(np.float32)


def class_embeddings(class_ids) -> np.ndarray:
    w = _embedding_map()
    emb = np.stack([w @ _class_theta(c) for c in class_ids])
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


class SyntheticVideoSource:
    """Deterministic per-(class, index) procedural videos."""

    def __init__(self, h: int = 160, w: int = 200, total_frames: int = 48):
        self.h, self.w, self.total_frames = h, w, total_frames

    def render(self, class_id: int, sample_idx: int) -> np.ndarray:
        """-> [total_frames, h, w, 3] uint8."""
        th = _class_theta(class_id)
        rng = np.random.default_rng((class_id << 20) ^ sample_idx)
        t = np.arange(self.total_frames, dtype=np.float32) / self.total_frames
        cx = (th[0] + 0.15 * np.sin(2 * np.pi * (t + rng.uniform(0, 1)))) * self.w
        cy = (th[1] + 0.15 * np.cos(2 * np.pi * (t + rng.uniform(0, 1)))) * self.h
        size = max(int(th[2] * 30) + 6, 6)
        color = (np.array([th[3], 1 - th[3], 0.5 + 0.5 * th[0]]) * 255).astype(np.uint8)
        vid = rng.integers(0, 40, size=(self.total_frames, self.h, self.w, 3),
                           dtype=np.uint8)
        for i in range(self.total_frames):
            y0 = int(np.clip(cy[i] - size, 0, self.h - 1))
            y1 = int(np.clip(cy[i] + size, 1, self.h))
            x0 = int(np.clip(cx[i] - size, 0, self.w - 1))
            x1 = int(np.clip(cx[i] + size, 1, self.w))
            vid[i, y0:y1, x0:x1] = color
        return vid

    def decode(self, class_id: int, sample_idx: int, clip_len: int,
               n_clips: int, is_validation: bool, rng=None):
        vid = self.render(class_id, sample_idx)
        idx = tsn_frame_indices(
            self.total_frames, clip_len, n_clips, is_validation, rng)
        return vid[idx], True


def build_synthetic_datasets(config) -> Dict[str, List[VideoTable]]:
    """Disjoint train/test class sets -> a real zero-shot protocol, no data
    on disk. Sizes come from --class_total / --train_samples (with small
    defaults)."""
    n_train_classes = config.class_total if config.class_total > 0 else 8
    n_test_classes = max(4, n_train_classes // 2)
    n_train = config.train_samples if config.train_samples > 0 else 64
    n_test = max(2 * n_test_classes, 16)

    def make(name, class_ids, n_samples, is_validation, n_clips):
        per = max(n_samples // len(class_ids), 1)
        labels, fnames = [], []
        for li, cid in enumerate(class_ids):
            for k in range(per):
                labels.append(li)
                fnames.append((cid, k))  # (class_id, sample_idx)
        return VideoTable(
            name=name,
            fnames=np.asarray(fnames, object),
            label_idx=np.asarray(labels, np.int32),
            classes=[f"class{c}" for c in class_ids],
            class_embed=class_embeddings(class_ids),
            loader="synthetic",
            is_validation=is_validation,
            n_clips=n_clips,
        )

    train_ids = list(range(n_train_classes))
    test_ids = list(range(n_train_classes, n_train_classes + n_test_classes))
    return {
        "training": [make("synthetic_train", train_ids, n_train, False,
                          config.n_clips)],
        "testing": [make("synthetic_test", test_ids, n_test, True,
                         config.eval_n_clips)],
    }
