"""The plain reference of the serve cell: a served video's scores worked out
again from its JPEG files.

Frame sampling as the reference's validation loader (TSN: n_clips windows
of clip_len frames, one at the start of each of n_clips equal periods,
counts past the end repeating the last frame, the list loop-padded), the
frames decoded with cv2 (BGR to RGB), resized with torch's bilinear
F.interpolate (short side to 128, align_corners=False, the given scale),
centre-cropped to 112 (offsets by Python's round), mapped to [-0.5, 0] as
((v / 255) - 1) / 2, the float32 forward with BN's running statistics,
the clips' mean, the head, and the cosine similarity to every class.
Imports nothing of the program.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import Net, identity


def tsn_indices(total: int, clip_len: int, n_clips: int) -> np.ndarray:
    period = max(total // n_clips, 1)
    n = min(n_clips, total // period)
    sel = np.concatenate([np.arange(o, o + clip_len)
                          for o in range(0, total, period)[:n]])
    sel = np.unique(sel)
    out, last = [], 0
    for s in sel:
        if s < total:
            last = s
        out.append(last)
    sel = np.asarray(out)
    want = n_clips * clip_len
    while len(sel) < want:
        sel = np.concatenate([sel, sel[:want - len(sel)]])
    return sel[:want]


def clips(video: str, n_clips: int, clip_len: int, crop: int,
          short: int = 128) -> torch.Tensor:
    """-> [n_clips, clip_len, crop, crop, 3] float32 of one frame directory."""
    import cv2

    images = os.path.join(video, "images")
    total = len(glob.glob(os.path.join(images, "*")))
    frames = []
    for i in tsn_indices(total, clip_len, n_clips):
        bgr = cv2.imread(os.path.join(images, "img_%05d.jpg" % (i + 1)))
        if bgr is None:
            raise RuntimeError(f"cv2 cannot read frame {i} of {video}")
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    x = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).float()
    h, w = x.shape[2], x.shape[3]
    scale = short / min(h, w)
    x = F.interpolate(x, scale_factor=scale, mode="bilinear",
                      align_corners=False, recompute_scale_factor=False)
    hr, wr = x.shape[2], x.shape[3]
    i, j = round((hr - crop) / 2.0), round((wr - crop) / 2.0)
    x = x[:, :, i:i + crop, j:j + crop]
    x = ((x / 255.0) - 1.0) / 2.0
    return x.permute(0, 2, 3, 1).reshape(n_clips, clip_len, crop, crop, 3)


@torch.no_grad()
def similarities(net: Net, params: dict, videos, class_embed: np.ndarray,
                 n_clips: int, device, quant=identity,
                 block: int = 8) -> np.ndarray:
    """-> [len(videos), C] cosine similarities of each video's embedding to
    every class embedding, in blocks of `block` videos."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    ce = torch.from_numpy(np.asarray(class_embed, np.float32)).to(device)
    ce = ce / torch.linalg.vector_norm(ce, dim=1, keepdim=True)
    out = []
    for k in range(0, len(videos), block):
        x = torch.stack([clips(v, n_clips, net.clip_len, net.size)
                         for v in videos[k:k + block]]).to(device)
        emb = net.forward(params, x, train=False, quant=quant)
        out.append((emb @ ce.t()).cpu().numpy())
    return np.concatenate(out)
