"""Caption vocabulary POS analysis (parity with the reference's make_words.py).

The port's copy of zeroshotvideoclassification_tpu/tools/caption_vocab.py:
the same flags, outputs and messages, its imports re-pointed at the port.

Buckets caption tokens by part of speech (nouns / verbs / adjectives / other)
using WordNet when available, else the embedded verb lexicon from text.lemma,
and reports frequency tables. The reference script was incomplete (no output,
reference/make_words.py); this version actually writes results.

Usage:
  python -m zeroshotvideoclassification_tpu_torch.tools.caption_vocab \
      --captions_root /data/Kinetics/Kinetics-700/frames --out vocab.json
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re


def pos_bucket(word: str) -> str:
    try:
        from nltk.corpus import wordnet as wn

        synsets = wn.synsets(word)
        if synsets:
            pos = collections.Counter(s.pos() for s in synsets).most_common(1)[0][0]
            return {"n": "noun", "v": "verb", "a": "adj", "s": "adj",
                    "r": "adv"}.get(pos, "other")
    except Exception:
        pass
    from zeroshotvideoclassification_tpu_torch.text.lemma import _fallback_base_verb

    return "verb" if _fallback_base_verb(word) else "other"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--captions_root", required=True)
    p.add_argument("--out", default="caption_vocab.json")
    args = p.parse_args(argv)

    buckets = collections.defaultdict(collections.Counter)
    for path in glob.glob(os.path.join(args.captions_root, "*", "captions.json")):
        with open(path) as f:
            captions = json.load(f)
        for cap in captions:
            for word in re.findall(r"[a-z]+", cap.lower()):
                buckets[pos_bucket(word)][word] += 1
    out = {b: dict(c.most_common(200)) for b, c in buckets.items()}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print({b: sum(c.values()) for b, c in buckets.items()})


if __name__ == "__main__":
    main()
