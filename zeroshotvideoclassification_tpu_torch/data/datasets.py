"""Dataset catalogs + composition (the reference's L2/L2.5 layers).

Catalog parity targets (reference/auxiliary/auxiliary_dataset.py:31-111,
auxiliary_activitynet.py:10-19, auxiliary_stillimages.py:9-25), with the
hardcoded /mnt/hdd1 roots replaced by Config.data_root. Composition parity:
reference/dataset.py (kinetics2oboth -> UCF+HMDB tests, kinetics2others
-> +ActivityNet, sun2both -> SUN image pretraining), including the tau overlap
filter wiring and eval clip counts (4 active / 25 --evaluate).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from zeroshotvideoclassification_tpu_torch.text import (
    classes2embedding,
    filter_classes,
    filter_overlapping_classes,
    filter_samples,
)


@dataclasses.dataclass
class VideoTable:
    """A catalogued dataset: file list + labels + class embeddings."""

    name: str
    fnames: np.ndarray          # object array of paths
    label_idx: np.ndarray       # int32 [N] indices into classes
    classes: List[str]
    class_embed: np.ndarray     # [C, 300] float32, unit rows
    loader: str                 # 'frame_dir' | 'video' | 'npy' | 'image' | 'synthetic'
    is_validation: bool
    n_clips: int = 1

    def __len__(self) -> int:
        return len(self.fnames)


def _label_indices(labels: Sequence[str]) -> (np.ndarray, List[str]):
    """label2index over the sorted unique label set (auxiliary_dataset.py:288-290)."""
    classes = sorted(set(labels))
    l2i = {l: i for i, l in enumerate(classes)}
    return np.asarray([l2i[l] for l in labels], np.int32), classes


# ------------------------------------------------------------- catalogs -----

def get_ucf101(root: str):
    """Frame dirs under {root}/UCF101/frames; label = basename.split('_')[1]."""
    folder = os.path.join(root, "UCF101", "frames")
    paths = sorted(glob.glob(os.path.join(folder, "*")))
    fnames, labels = [], []
    for path in paths:
        fnames.append(path)
        labels.append(os.path.basename(path).split("_")[1])
    return np.asarray(fnames, object), np.asarray(labels), np.unique(labels)


def get_hmdb(root: str):
    """hmdb51.json + hmdb51_classes.txt map; labels de-underscored."""
    rf = os.path.join(root, "HMDB51")
    with open(os.path.join(rf, "hmdb51.json")) as fp:
        gt = json.load(fp)
    class_map = {}
    with open(os.path.join(rf, "hmdb51_classes.txt")) as fp:
        for line in fp:
            line = line.rstrip()
            if not line:
                continue
            name, idx = line.split(" ")
            class_map[int(idx)] = name
    fnames, labels = [], []
    for fname in sorted(glob.glob(os.path.join(rf, "frames", "*"))):
        fnames.append(fname)
        key = os.path.basename(fname).split(".")[0]
        label = class_map[gt["database"][key]["annotations"]]
        labels.append(label.replace("_", " "))
    return np.asarray(fnames, object), np.asarray(labels), np.unique(labels)


def get_kinetics(root: str, n_classes: str = "700"):
    """meta.json + frame-folder glob (auxiliary_dataset.py:89-111)."""
    base = os.path.join(root, "Kinetics", f"Kinetics-{n_classes}")
    with open(os.path.join(base, "annotations", "meta.json")) as fp:
        meta = json.load(fp)
    fnames, labels = [], []
    # sorted: the reference iterated the raw glob (its order is
    # filesystem-dependent), but table order here must be deterministic —
    # multi-host lockstep sharding slices each process's own table by index
    # (parallel.multihost.shard_table), and --train_samples subsets by
    # position (text.filters.filter_samples)
    for folder in sorted(glob.glob(os.path.join(base, "frames", "*"))):
        fnames.append(folder)
        labels.append(meta[os.path.basename(folder)])
    classes = sorted(np.unique(labels).tolist())
    return np.asarray(fnames, object), np.asarray(labels), classes


def get_activitynet(root: str):
    """annotations_all.csv of pre-cut .npy clips (auxiliary_activitynet.py:10-19)."""
    src = os.path.join(root, "ActivityNet", "v1.3", "clips")
    with open(os.path.join(src, "annotations_all.csv")) as f:
        lines = [l.rstrip("\n").split(",") for l in f]
    fnames = [os.path.join(src, l[0] + ".npy") for l in lines]
    labels = [l[1] for l in lines]
    return np.asarray(fnames, object), np.asarray(labels), np.unique(labels)


SUN_EXCLUDED = ("barndoor", "thriftshop")


def get_sun(root: str):
    """SUN397 still images; 2 classes excluded (auxiliary_stillimages.py:9-25)."""
    directory = os.path.join(root, "SUN397")
    with open(os.path.join(directory, "ClassName.txt")) as f:
        classes_path = [l.rstrip("\n") for l in f]
    fnames, labels = [], []
    for cp in classes_path:
        label = cp[3:]
        if label in SUN_EXCLUDED:
            continue
        fold = directory + cp
        # sorted for the same determinism reasons as get_kinetics (readdir
        # order is filesystem-dependent; the class file list itself is fixed)
        for fname in sorted(os.listdir(fold)):
            fnames.append(os.path.join(fold, fname))
            labels.append(label)
    return np.asarray(fnames, object), np.asarray(labels), np.unique(labels)


_warned_no_broken_list = [False]


def clean_kinetics(fnames, labels,
                   broken_list_path: str = "assets/kinetics_broken_videos.txt"):
    """Scrub known-broken Kinetics videos. The reference matched fname[75:]
    against the list (a hardcoded path-prefix length, quirk #12); here the
    match is on the trailing path components.

    The default path is cwd-relative (the repo-wide ./assets convention);
    when it is missing there, the repo-root copy next to the package is
    tried, and an absent list warns ONCE instead of silently reintroducing
    every known-broken video (a decode-failure debugging trap when training
    is launched from outside the repo root)."""
    if not os.path.exists(broken_list_path):
        anchored = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), broken_list_path)
        if not os.path.isabs(broken_list_path) and os.path.exists(anchored):
            broken_list_path = anchored
        else:
            if not _warned_no_broken_list[0]:
                import sys

                print(f"WARNING: broken-videos list {broken_list_path!r} "
                      f"not found; skipping the Kinetics scrub",
                      file=sys.stderr)
                _warned_no_broken_list[0] = True
            return fnames, labels
    with open(broken_list_path) as f:
        broken = set(l.rstrip("\n") for l in f)

    def is_broken(path: str) -> bool:
        parts = path.split(os.sep)
        return any(os.sep.join(parts[-k:]) in broken for k in (1, 2, 3))

    keep = np.asarray([not is_broken(f) for f in fnames])
    return fnames[keep], labels[keep]


# ------------------------------------------------------------ composition ---

def build_datasets(config, wv_model) -> Dict[str, List[VideoTable]]:
    """-> {'training': [VideoTable], 'testing': [VideoTable, ...]}.

    Route on the --dataset string like reference/dataset.py:10-19 (but
    actually honoring the route, unlike the reference's hardcoded
    get_both_datasets — quirk #2)."""
    if "synthetic" in config.dataset:
        from zeroshotvideoclassification_tpu_torch.data.synthetic import build_synthetic_datasets
        return build_synthetic_datasets(config)
    if "other" in config.dataset:
        return _compose(config, wv_model, with_activitynet=True)
    if "image" in config.dataset or "sun" in config.dataset:
        return _compose_sun(config, wv_model)
    return _compose(config, wv_model, with_activitynet=False)


def _test_table(config, name, fnames, labels, classes, embed, loader) -> VideoTable:
    label_idx, cls_sorted = _label_indices(list(labels))
    assert list(cls_sorted) == list(classes), (name, "class order mismatch")
    return VideoTable(
        name=name, fnames=fnames, label_idx=label_idx, classes=list(classes),
        class_embed=embed, loader=loader, is_validation=True,
        n_clips=config.eval_n_clips)


def _compose(config, wv_model, with_activitynet: bool):
    root = config.data_root
    out: Dict[str, List[VideoTable]] = {"training": [], "testing": []}

    ucf_f, ucf_l, ucf_c = get_ucf101(root)
    ucf_e = classes2embedding("ucf101", list(ucf_c), wv_model)
    hm_f, hm_l, hm_c = get_hmdb(root)
    hm_e = classes2embedding("hmdb51", list(hm_c), wv_model)
    test_embeds = [ucf_e, hm_e]

    an = None
    if with_activitynet:
        an_f, an_l, an_c = get_activitynet(root)
        an_e = classes2embedding("activitynet", list(an_c), wv_model)
        test_embeds.append(an_e)
        an = (an_f, an_l, an_c, an_e)

    if not config.evaluate:
        k_f, k_l, k_c = get_kinetics(root, "700")
        k_f, k_l = clean_kinetics(k_f, k_l)
        k_f, k_l, k_c = filter_samples(config.train_samples, k_f, k_l, k_c)
        k_e = classes2embedding("kinetics", list(k_c), wv_model)
        k_f, k_l, k_c, k_e = filter_overlapping_classes(
            list(k_f), list(k_l), list(k_c), k_e,
            np.concatenate(test_embeds), config.class_overlap)
        k_f, k_l, k_c, k_e = filter_classes(
            config.class_total, k_f, k_l, k_c, k_e)
        label_idx, classes = _label_indices(list(k_l))
        # re-order embeddings to the sorted-class index space
        order = [list(k_c).index(c) for c in classes]
        out["training"].append(VideoTable(
            name=f"kinetics{len(classes)}", fnames=np.asarray(k_f, object),
            label_idx=label_idx, classes=classes, class_embed=k_e[order],
            loader="frame_dir", is_validation=False, n_clips=config.n_clips))

    out["testing"].append(_test_table(
        config, "ucf101", ucf_f, ucf_l, list(ucf_c), ucf_e, "frame_dir"))
    out["testing"].append(_test_table(
        config, "hmdb51", hm_f, hm_l, list(hm_c), hm_e, "frame_dir"))
    # Reference parity (dataset.py:88-91): the 'others' route evaluates on
    # ActivityNet ONLY under --evaluate (first in the list); during training
    # its class embeddings still join the tau overlap filter above.
    if with_activitynet and an is not None and config.evaluate:
        an_f, an_l, an_c, an_e = an
        out["testing"].insert(0, _test_table(
            config, "ActivityNet", an_f, an_l, list(an_c), an_e, "npy"))
    return out


def _compose_sun(config, wv_model):
    root = config.data_root
    out: Dict[str, List[VideoTable]] = {"training": [], "testing": []}
    s_f, s_l, s_c = get_sun(root)
    s_e = classes2embedding("sun", list(s_c), wv_model)
    label_idx, classes = _label_indices(list(s_l))
    out["training"].append(VideoTable(
        name="sun", fnames=s_f, label_idx=label_idx, classes=classes,
        class_embed=s_e, loader="image", is_validation=False,
        n_clips=config.n_clips))
    ucf_f, ucf_l, ucf_c = get_ucf101(root)
    ucf_e = classes2embedding("ucf101", list(ucf_c), wv_model)
    hm_f, hm_l, hm_c = get_hmdb(root)
    hm_e = classes2embedding("hmdb51", list(hm_c), wv_model)
    out["testing"].append(_test_table(
        config, "ucf101", ucf_f, ucf_l, list(ucf_c), ucf_e, "frame_dir"))
    out["testing"].append(_test_table(
        config, "hmdb51", hm_f, hm_l, list(hm_c), hm_e, "frame_dir"))
    return out
