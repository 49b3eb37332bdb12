"""Semantic-embedding layer: class names -> L2-normalized 300-d vectors.

Pure-numpy replacement for the reference's gensim/NLTK stack
(reference/auxiliary/auxiliary_word2vec.py). Everything here is offline
asset preparation and runs on the host; the resulting [n_classes, 300] arrays
are the supervision targets and the retrieval keys for zero-shot evaluation.
"""

from zeroshotvideoclassification_tpu_torch.text.word2vec import (
    WordVectors,
    load_word2vec,
    SyntheticWordVectors,
)
from zeroshotvideoclassification_tpu_torch.text.class_names import (
    classes2embedding,
    class_name_to_words,
)
from zeroshotvideoclassification_tpu_torch.text.filters import (
    filter_samples,
    filter_classes,
    filter_overlapping_classes,
    cosine_cdist,
)
from zeroshotvideoclassification_tpu_torch.text.lemma import verbs2basicform

__all__ = [
    "WordVectors",
    "load_word2vec",
    "SyntheticWordVectors",
    "classes2embedding",
    "class_name_to_words",
    "filter_samples",
    "filter_classes",
    "filter_overlapping_classes",
    "cosine_cdist",
    "verbs2basicform",
]
