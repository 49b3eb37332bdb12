"""Offline Word2Vec asset preparation.

The port's copy of zeroshotvideoclassification_tpu/tools/prepare_word2vec.py:
the same flags, outputs and messages, its imports re-pointed at the port.

Replaces the reference's install.sh + gensim load/save dance
(reference/assets/download_word2vec.sh,
reference/auxiliary/auxiliary_word2vec.py:35-50): parse the GoogleNews
binary once, unit-normalize, append <EOS>/<UNK>, and cache a compressed .npz
that every later run loads in seconds.

Usage:
  python -m zeroshotvideoclassification_tpu_torch.tools.prepare_word2vec \
      --bin assets/GoogleNews-vectors-negative300.bin \
      --out assets/word2vec_cache.npz
Use --limit N to parse only the first N (most frequent) vocabulary entries
when a smaller cache suffices.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bin", default="assets/GoogleNews-vectors-negative300.bin")
    p.add_argument("--out", default="assets/word2vec_cache.npz")
    p.add_argument("--limit", type=int, default=None,
                   help="parse only the first N vocabulary entries")
    args = p.parse_args(argv)

    from zeroshotvideoclassification_tpu_torch.text.word2vec import (
        load_word2vec,
        parse_word2vec_bin,
    )

    if args.limit:
        import numpy as np

        wv = parse_word2vec_bin(args.bin, limit=args.limit)
        vecs = wv.vectors / np.maximum(
            np.linalg.norm(wv.vectors, axis=1, keepdims=True), 1e-12)
        from zeroshotvideoclassification_tpu_torch.text.word2vec import WordVectors

        WordVectors(list(wv.index.keys()), vecs).save_npz(args.out)
    else:
        load_word2vec(args.bin, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
