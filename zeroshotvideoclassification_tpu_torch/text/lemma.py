"""Verb lemmatization for class-name tokens.

The reference lemmatizes any token that has a WordNet verb synset back to its
base verb form (`verbs2basicform`, reference/auxiliary/auxiliary_word2vec.py:212-219)
so e.g. 'running'->'run', 'cutting'->'cut' before Word2Vec lookup.

This module prefers the NLTK WordNet corpus when it is installed (exact
reference parity). When the corpus is unavailable (air-gapped TPU hosts), it
falls back to a faithful reimplementation of NLTK's verb `_morphy` — the
same exception-table lookup, rules of detachment, iterative re-application,
and shortest-candidate selection — driven by a vendored WordNet 3.0 subset
(`wordnet_verbs/verb.exc` + `wordnet_verbs/index.verb.lemmas`) covering the
UCF101/HMDB51/Kinetics/ActivityNet class vocabularies. Provenance and the
re-extraction procedure are documented in `wordnet_verbs/README.md`; the
goldens in tests/fixtures/lemma_goldens.json pin the resulting behavior.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Optional NLTK backend
# --------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _nltk_backend():
    """Return (synsets_fn, lemmatize_fn) if the WordNet corpus is usable."""
    try:
        from nltk.corpus import wordnet as wn
        from nltk.stem.wordnet import WordNetLemmatizer

        wn.synsets("run")  # force-load; raises LookupError w/o corpus files
        lem = WordNetLemmatizer()
        return (lambda w: wn.synsets(w), lambda w: lem.lemmatize(w, "v"))
    except Exception:
        return None


# --------------------------------------------------------------------------
# Offline fallback: WordNet verb morphy over the vendored corpus subset
# --------------------------------------------------------------------------

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "wordnet_verbs")

# NLTK MORPHOLOGICAL_SUBSTITUTIONS[VERB]: rules of detachment, applied in
# order; a rule fires whenever the suffix matches (no length guard — empty
# or nonsense stems are discarded by the index-membership filter).
_VERB_RULES = (
    ("s", ""),
    ("ies", "y"),
    ("es", "e"),
    ("es", ""),
    ("ed", "e"),
    ("ed", ""),
    ("ing", "e"),
    ("ing", ""),
)


@lru_cache(maxsize=1)
def _load_data() -> Tuple[Dict[str, List[str]], FrozenSet[str]]:
    """Parse the vendored verb.exc + index.verb.lemmas files once."""
    exc: Dict[str, List[str]] = {}
    with open(os.path.join(_DATA_DIR, "verb.exc")) as f:
        for ln in f:
            parts = ln.split()
            if parts:
                exc[parts[0]] = parts[1:]
    with open(os.path.join(_DATA_DIR, "index.verb.lemmas")) as f:
        index = frozenset(w for w in (ln.strip() for ln in f) if w)
    return exc, index


def _apply_rules(forms: List[str]) -> List[str]:
    return [f[: -len(suf)] + rep
            for f in forms for suf, rep in _VERB_RULES if f.endswith(suf)]


def _morphy_verb(form: str) -> List[str]:
    """WordNet verb morphy over the vendored subset.

    Mirrors nltk.corpus.reader.wordnet._morphy(form, VERB): exception-list
    hit short-circuits; otherwise detachment rules run once (keeping the
    form itself as a candidate) and then re-apply iteratively until some
    candidate is a known verb lemma."""
    exc, index = _load_data()

    def filt(forms: List[str]) -> List[str]:
        out, seen = [], set()
        for f in forms:
            if f in index and f not in seen:
                out.append(f)
                seen.add(f)
        return out

    if form in exc:
        return filt([form] + exc[form])
    forms = _apply_rules([form])
    results = filt([form] + forms)
    if results:
        return results
    while forms:
        forms = _apply_rules(forms)
        results = filt(forms)
        if results:
            return results
    return []


def _fallback_base_verb(word: str) -> Optional[str]:
    """Return the base verb form if `word` looks like an (inflected) verb.

    None means "no verb reading" (the reference's gate: wn.synsets(w) has no
    verb synset — equivalently, verb morphy finds no lemma). Otherwise the
    result follows WordNetLemmatizer.lemmatize(word, 'v'): the SHORTEST
    surviving candidate (ties -> first). The min-by-length step is
    observable on real class names — WordNet maps 'planing' to 'plan', not
    'plane', because both detach and 'plan' is shorter."""
    cands = _morphy_verb(word)
    return min(cands, key=len) if cands else None


def verbs2basicform(words: Sequence[str]) -> List[str]:
    """Lemmatize each word to its base verb form iff it has a verb reading.

    Parity target: reference/auxiliary/auxiliary_word2vec.py:212-219.
    """
    backend = _nltk_backend()
    ret = []
    for w in words:
        if backend is not None:
            synsets_fn, lemmatize_fn = backend
            if any(s.pos() == "v" for s in synsets_fn(w)):
                w = lemmatize_fn(w)
        else:
            base = _fallback_base_verb(w)
            if base is not None:
                w = base
        ret.append(w)
    return ret
