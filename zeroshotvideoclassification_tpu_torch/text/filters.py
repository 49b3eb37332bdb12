"""Train-set hygiene filters (host-side, numpy).

Parity targets: reference/auxiliary/auxiliary_dataset.py:115-152.
These run once at dataset-assembly time, so plain numpy is the right tool;
the on-device cosine kernels live in ops/cdist.py for the hot eval path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def cosine_cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise cosine distance 1 - <a,b>/(|a||b|), scipy-cdist semantics."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-30)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-30)
    return 1.0 - an @ bn.T


def filter_samples(
    train_samples: int, fnames, labels, classes
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linspace-subsample the sample list to `train_samples` (-1 = keep all).

    Parity: auxiliary_dataset.py:115-123."""
    fnames, labels = np.asarray(fnames), np.asarray(labels)
    if train_samples != -1:
        sel = np.linspace(
            0, len(fnames) - 1, min(train_samples, len(fnames))
        ).astype(int)
        fnames, labels = fnames[sel], labels[sel]
    return fnames, labels, np.asarray(classes)


def filter_classes(
    class_total: int, fnames, labels, classes, class_embedding: np.ndarray
):
    """Linspace-subsample the class list to `class_total` (<=0 = keep all).

    Parity: auxiliary_dataset.py:126-138."""
    if class_total > 0:
        sel = np.linspace(0, len(classes) - 1, class_total).astype(int)
    else:
        sel = np.ones(len(classes), dtype=bool)
    classes = np.asarray(classes)[sel].tolist()
    class_embedding = class_embedding[sel]
    keep = set(classes)
    fnames = [f for f, l in zip(fnames, labels) if l in keep]
    labels = [l for l in labels if l in keep]
    return np.asarray(fnames), np.asarray(labels), np.asarray(classes), class_embedding


def filter_overlapping_classes(
    fnames,
    labels,
    classes: Sequence[str],
    class_embedding: np.ndarray,
    test_class_embedding: np.ndarray,
    class_overlap: float,
):
    """Drop any train class whose min cosine distance to ANY test class is
    <= tau (paper Eq. 3). Parity: auxiliary_dataset.py:141-152 (strict '>')."""
    class_distances = cosine_cdist(class_embedding, test_class_embedding).min(axis=1)
    sel = class_distances > class_overlap
    classes = np.asarray(classes)[sel].tolist()
    class_embedding = class_embedding[sel]
    keep = set(classes)
    fnames = [f for f, l in zip(fnames, labels) if l in keep]
    labels = [l for l in labels if l in keep]
    return fnames, labels, classes, class_embedding
