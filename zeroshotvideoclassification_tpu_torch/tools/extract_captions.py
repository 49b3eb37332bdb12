"""Offline frame captioning for dataset exploration (vestigial-path parity).

The port's copy of zeroshotvideoclassification_tpu/tools/extract_captions.py:
the same flags, outputs and messages, its imports re-pointed at the port.

The reference ships extract_captions.py — MAGIC zero-shot captioning (CLIP
ViT-B/32 + SimCTG GPT-2 contrastive decoding) over Kinetics frame folders,
writing a captions.json per folder (reference/extract_captions.py).
That tool is NOT part of the train/eval path (SURVEY §2.1 'vestigial'); this
equivalent reproduces the capability with the baked-in transformers stack:
CLIP-guided greedy decoding from a GPT-2 LM (plug-and-play: each step's
top-k LM candidates are rescored by CLIP image-text similarity).

Requires downloaded HF weights (openai/clip-vit-base-patch32 + gpt2); on
air-gapped hosts this tool is import-gated and exits with a clear message.

Usage:
  python -m zeroshotvideoclassification_tpu_torch.tools.extract_captions \
      --frames_root /data/Kinetics/Kinetics-700/frames --num_frames 4
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _load_models():
    try:
        import torch  # noqa: F401
        from transformers import (
            CLIPModel,
            CLIPProcessor,
            GPT2LMHeadModel,
            GPT2Tokenizer,
        )
    except Exception as e:  # pragma: no cover
        raise SystemExit(f"captioning needs transformers+torch with weights: {e}")
    clip = CLIPModel.from_pretrained("openai/clip-vit-base-patch32")
    clip_proc = CLIPProcessor.from_pretrained("openai/clip-vit-base-patch32")
    lm = GPT2LMHeadModel.from_pretrained("gpt2")
    tok = GPT2Tokenizer.from_pretrained("gpt2")
    return clip, clip_proc, lm, tok


def caption_image(image, models, max_len: int = 16, k: int = 15,
                  alpha: float = 0.6) -> str:
    """CLIP-reranked top-k greedy decoding (plug-and-play guidance)."""
    import torch

    clip, clip_proc, lm, tok = models
    with torch.no_grad():
        img_feat = clip.get_image_features(
            **clip_proc(images=image, return_tensors="pt"))
        img_feat = img_feat / img_feat.norm(dim=-1, keepdim=True)
        ids = tok.encode("A picture of", return_tensors="pt")
        for _ in range(max_len):
            logits = lm(ids).logits[0, -1]
            topk = torch.topk(logits, k)
            texts = [tok.decode(torch.cat([ids[0], c[None]]))
                     for c in topk.indices]
            t_in = clip_proc(text=texts, return_tensors="pt", padding=True,
                             truncation=True)
            t_feat = clip.get_text_features(**t_in)
            t_feat = t_feat / t_feat.norm(dim=-1, keepdim=True)
            clip_score = (t_feat @ img_feat.T).squeeze(-1)
            lm_prob = torch.softmax(topk.values, -1)
            best = int(torch.argmax((1 - alpha) * lm_prob + alpha * clip_score))
            ids = torch.cat([ids, topk.indices[best][None, None]], dim=1)
            if topk.indices[best] == tok.eos_token_id:
                break
        return tok.decode(ids[0], skip_special_tokens=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames_root", required=True)
    p.add_argument("--num_frames", type=int, default=4)
    p.add_argument("--max_len", type=int, default=16)
    args = p.parse_args(argv)

    from PIL import Image
    import numpy as np

    models = _load_models()
    for folder in sorted(glob.glob(os.path.join(args.frames_root, "*"))):
        images = sorted(glob.glob(os.path.join(folder, "images", "*.jpg")))
        if not images:
            continue
        sel = np.linspace(0, len(images) - 1, args.num_frames).astype(int)
        captions = [caption_image(Image.open(images[i]), models,
                                  max_len=args.max_len) for i in sel]
        with open(os.path.join(folder, "captions.json"), "w") as f:
            json.dump(captions, f)
        print(folder, captions[0])


if __name__ == "__main__":
    main()
