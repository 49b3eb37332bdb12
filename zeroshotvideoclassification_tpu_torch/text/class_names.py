"""Class-name -> word-list -> 300-d embedding rules, per dataset.

Behavioral parity target: reference/auxiliary/auxiliary_word2vec.py:13-209.
Each dataset has a tokenization rule plus a hand-curated override table (the
override tables are data, reproduced verbatim for embedding parity — they pin
the supervision targets of the whole system). Per class: mean of constituent
word vectors; then the stacked [n_classes, 300] matrix is row-L2-normalized.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from zeroshotvideoclassification_tpu_torch.text.lemma import verbs2basicform

# --------------------------------------------------------------------------
# Override tables (data; parity with auxiliary_word2vec.py:53-209)
# --------------------------------------------------------------------------

_UCF_OVERRIDES: Dict[str, List[str]] = {
    "CleanAndJerk": ["weight", "lift"],
    "Skijet": ["Skyjet"],
    "HandStandPushups": ["handstand", "pushups"],
    "HandstandPushups": ["handstand", "pushups"],
    "PushUps": ["pushups"],
    "PullUps": ["pullups"],
    "WalkingWithDog": ["walk", "dog"],
    "ThrowDiscus": ["throw", "disc"],
    "TaiChi": ["taichi"],
    "CuttingInKitchen": ["cut", "kitchen"],
    "YoYo": ["yoyo"],
}

_HMDB_OVERRIDES: Dict[str, List[str]] = {"claping": ["clapping"]}

_KINETICS_OVERRIDES: Dict[str, List[str]] = {
    "clean and jerk": ["weight", "lift"],
    "dancing gangnam style": ["dance", "korean"],
    "breading or breadcrumbing": ["bread", "crumb"],
    "eating doughnuts": ["eat", "bun"],
    "faceplanting": ["face", "fall"],
    "hoverboarding": ["skateboard", "electric"],
    "hurling (sport)": ["hurl", "sport"],
    "jumpstyle dancing": ["jumping", "dance"],
    "passing American football (in game)": ["pass", "american", "football", "match"],
    "passing American football (not in game)": ["pass", "american", "football", "park"],
    "petting animal (not cat)": ["pet", "animal"],
    "punching person (boxing)": ["punch", "person", "boxing"],
    's head": 1}': ["head"],
    "shooting goal (soccer)": ["shoot", "goal", "soccer"],
    "skiing (not slalom or crosscountry)": ["ski"],
    "throwing axe": ["throwing", "ax"],
    "tying knot (not on a tie)": ["ty", "knot"],
    "using remote controller (not gaming)": ["remote", "control"],
    "backflip (human)": ["backflip", "human"],
    "blowdrying hair": ["dry", "hair"],
    "making paper aeroplanes": ["make", "paper", "airplane"],
    "mixing colours": ["mix", "colors"],
    "photobombing": ["take", "picture"],
    "playing rubiks cube": ["play", "cube"],
    "pretending to be a statue": ["pretend", "statue"],
    "throwing ball (not baseball or American football)": ["throw", "ball"],
    "curling (sport)": ["curling", "sport"],
    "massaging person's head": ["massage", "person", "head"],
}

_ACTIVITYNET_OVERRIDES: Dict[str, List[str]] = {
    "Blow-drying_hair": ["dry", "hair"],
    "Playing_rubik_cube": ["play", "cube"],
    "Carving_jack-o-lanterns": ["carve", "pumpkin"],
    "Mooping_floor": ["mop", "floor"],
    "Ping-pong": ["table", "tennis"],
    "Plataform_diving": ["diving", "trampoline"],
    "Polishing_forniture": ["polish", "furniture"],
    "Powerbocking": ["jump", "shoes"],
    "Rock-paper-scissors": ["play", "rock", "paper", "scissors"],
}

_SUN_OVERRIDES: Dict[str, List[str]] = {
    "car_interior/frontseat": ["car", "interior", "front", "seat"],
    "forest/needleleaf": ["forest", "needle", "leaf"],
    "theater/indoor_procenium": ["theater", "indoor"],
    "videostore": ["video", "store"],
}

_KINETICS_STOPWORDS = (
    "a", "the", "of", " ", "", "and", "at", "on", "in", "an", "or",
    "do", "using", "with",
)
# ActivityNet's list drops 'or' relative to Kinetics (auxiliary_word2vec.py:187).
_ACTIVITYNET_STOPWORDS = (
    "a", "the", "of", " ", "", "and", "at", "on", "in", "an",
    "do", "using", "with",
)


# --------------------------------------------------------------------------
# Tokenization rules
# --------------------------------------------------------------------------


def _ucf_words(name: str) -> List[str]:
    """CamelCase split (each uppercase letter starts a new word), lowercase,
    lemmatize. Parity: auxiliary_word2vec.py:53-87."""
    if name in _UCF_OVERRIDES:
        return list(_UCF_OVERRIDES[name])
    upper_idx = [i for i, ch in enumerate(name) if ch.isupper()] + [len(name)]
    words = [name[upper_idx[i]: upper_idx[i + 1]] for i in range(len(upper_idx) - 1)]
    return verbs2basicform([w.lower() for w in words])


def _hmdb_words(name: str) -> List[str]:
    """Space split + typo fix; lemmatize. Parity: auxiliary_word2vec.py:90-107.

    Note the reference lemmatizes override results too for HMDB (unlike UCF)."""
    words = list(_HMDB_OVERRIDES.get(name, name.split(" ")))
    return verbs2basicform(words)


def _drop_not_suffix(words: List[str]) -> List[str]:
    not_id = [i for i, w in enumerate(words) if w == "(not"]
    return words[: not_id[0]] if not_id else words


def _kinetics_words(name: str) -> List[str]:
    """Lowercase, stopword-remove, '(not ...' truncate, paren strip, lemmatize.
    Parity: auxiliary_word2vec.py:110-165."""
    if name in _KINETICS_OVERRIDES:
        return list(_KINETICS_OVERRIDES[name])
    words = [w for w in name.lower().split(" ") if w not in _KINETICS_STOPWORDS]
    words = _drop_not_suffix(words)
    words = [w.replace("(", "").replace(")", "") for w in words]
    return verbs2basicform(words)


def _activitynet_words(name: str) -> List[str]:
    """Leading-space strip, underscore split, stopword-remove, lemmatize.
    Parity: auxiliary_word2vec.py:168-195."""
    name = name[1:] if name and name[0] == " " else name
    if name in _ACTIVITYNET_OVERRIDES:
        return list(_ACTIVITYNET_OVERRIDES[name])
    words = name.lower().replace("_", " ").split(" ")
    words = [w for w in words if w not in _ACTIVITYNET_STOPWORDS]
    words = _drop_not_suffix(words)
    words = [w.replace("(", "").replace(")", "") for w in words]
    return verbs2basicform(words)


def _sun_words(name: str) -> List[str]:
    """'/' and '_' split, no lemmatization. Parity: auxiliary_word2vec.py:198-209."""
    if name in _SUN_OVERRIDES:
        return list(_SUN_OVERRIDES[name])
    return name.lower().replace("/", "_").split("_")


_RULES: Dict[str, Callable[[str], List[str]]] = {
    "ucf101": _ucf_words,
    "hmdb51": _hmdb_words,
    "kinetics": _kinetics_words,
    "activitynet": _activitynet_words,
    "sun": _sun_words,
}


def class_name_to_words(dataset_name: str, class_name: str) -> List[str]:
    """Map a raw dataset class name to its Word2Vec lookup tokens."""
    try:
        rule = _RULES[dataset_name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {dataset_name!r}; expected one of {sorted(_RULES)}"
        ) from None
    return rule(class_name)


def classes2embedding(
    dataset_name: str, class_names: Sequence[str], wv_model
) -> np.ndarray:
    """[n_classes, 300] embedding matrix: per-class token-mean, then row-L2 norm.

    Parity: auxiliary_word2vec.py:13-32 (mean of word vectors per class,
    sklearn-normalize over the stacked matrix).
    """
    rows = []
    for name in class_names:
        words = class_name_to_words(dataset_name, name)
        rows.append(np.asarray(wv_model[words], dtype=np.float32).mean(axis=0))
    emb = np.stack(rows).astype(np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def classes2words(
    dataset_name: str, class_names: Sequence[str]
) -> List[Tuple[str, List[str]]]:
    """Debug helper: the token list chosen for every class."""
    return [(n, class_name_to_words(dataset_name, n)) for n in class_names]
