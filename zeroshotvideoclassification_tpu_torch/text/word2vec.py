"""GoogleNews Word2Vec loading without gensim.

The reference loads the 3.6 GB GoogleNews binary through gensim, unit-
normalizes every vector (init_sims(replace=True)), appends random <EOS>/<UNK>
vectors, and re-saves (reference/auxiliary/auxiliary_word2vec.py:35-50).

Here the binary format is parsed directly with numpy (it is a trivial format:
an ASCII header "vocab dim\\n", then per entry a space-terminated token
followed by dim float32s), normalized once, and cached as a compressed .npz so
subsequent runs mmap-load instantly. A deterministic synthetic table backs
tests and air-gapped smoke runs.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence

import numpy as np


class WordVectors:
    """Immutable token -> unit-norm vector table with gensim-like indexing."""

    def __init__(self, tokens: Sequence[str], vectors: np.ndarray):
        assert len(tokens) == len(vectors), (len(tokens), vectors.shape)
        self.index: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.vectors = np.asarray(vectors, dtype=np.float32)
        self.dim = int(self.vectors.shape[1])

    def __contains__(self, token: str) -> bool:
        return token in self.index

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, tokens) -> np.ndarray:
        """Look up one token -> [dim] or a list of tokens -> [n, dim].

        Mirrors gensim KeyedVectors.__getitem__ as used at
        reference/auxiliary/auxiliary_word2vec.py:87 (wv_model[name_vec]).
        Raises KeyError on out-of-vocabulary tokens, like the reference.
        """
        if isinstance(tokens, str):
            return self.vectors[self.index[tokens]]
        rows = [self.index[t] for t in tokens]
        return self.vectors[rows]

    def save_npz(self, path: str) -> None:
        tokens = np.array(list(self.index.keys()), dtype=object)
        np.savez_compressed(path, tokens=tokens, vectors=self.vectors)

    @staticmethod
    def load_npz(path: str) -> "WordVectors":
        data = np.load(path, allow_pickle=True)
        return WordVectors(list(data["tokens"]), data["vectors"])


def parse_word2vec_bin(path: str, limit: int | None = None) -> WordVectors:
    """Parse the word2vec C binary format (GoogleNews-vectors-negative300.bin)."""
    with open(path, "rb") as f:
        header = f.readline().split()
        vocab_size, dim = int(header[0]), int(header[1])
        if limit is not None:
            vocab_size = min(vocab_size, limit)
        vectors = np.empty((vocab_size, dim), dtype=np.float32)
        tokens: List[str] = []
        binary_len = 4 * dim
        for i in range(vocab_size):
            chars = bytearray()
            while True:
                ch = f.read(1)
                if ch == b" ":
                    break
                if ch == b"":
                    raise EOFError("truncated word2vec binary at entry %d" % i)
                if ch != b"\n":  # leading newlines separate some entries
                    chars.extend(ch)
            tokens.append(chars.decode("utf-8", errors="replace"))
            vectors[i] = np.frombuffer(f.read(binary_len), dtype=np.float32)
    return WordVectors(tokens, vectors)


def _unit_normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-12)


def load_word2vec(
    bin_path: str = "./assets/GoogleNews-vectors-negative300.bin",
    cache_path: str = "./assets/word2vec_cache.npz",
    seed: int = 0,
) -> WordVectors:
    """Load (or build+cache) the normalized GoogleNews table.

    Semantics parity with reference/auxiliary/auxiliary_word2vec.py:35-50:
    every vocabulary vector is L2-normalized; then unnormalized random
    <EOS>/<UNK> vectors are appended (the reference draws them unseeded; here
    the draw is seeded for reproducibility — they are never hit by class-name
    lookups, only kept for API parity).
    """
    if cache_path and os.path.exists(cache_path):
        return WordVectors.load_npz(cache_path)
    wv = parse_word2vec_bin(bin_path)
    vectors = _unit_normalize(wv.vectors)
    rng = np.random.default_rng(seed)
    extra = rng.normal(size=(2, wv.dim)).astype(np.float32)
    tokens = list(wv.index.keys()) + ["<EOS>", "<UNK>"]
    out = WordVectors(tokens, np.concatenate([vectors, extra], axis=0))
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        out.save_npz(cache_path)
    return out


class SyntheticWordVectors(WordVectors):
    """Deterministic hash-seeded unit vectors for any token.

    Used by tests and the synthetic data pipeline; behaves like WordVectors
    but never raises KeyError — every token deterministically maps to a fixed
    pseudo-random unit vector, so embedding-space geometry is stable across
    processes and runs.
    """

    def __init__(self, dim: int = 300):
        self.dim = dim
        self.index = {}
        self.vectors = np.zeros((0, dim), dtype=np.float32)
        self._cache: Dict[str, np.ndarray] = {}

    def _vec(self, token: str) -> np.ndarray:
        v = self._cache.get(token)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(token.encode(), digest_size=8).digest(), "little"
            )
            rng = np.random.default_rng(seed)
            v = rng.normal(size=(self.dim,)).astype(np.float32)
            v /= max(float(np.linalg.norm(v)), 1e-12)
            self._cache[token] = v
        return v

    def __contains__(self, token: str) -> bool:
        return True

    def __getitem__(self, tokens) -> np.ndarray:
        if isinstance(tokens, str):
            return self._vec(tokens)
        return np.stack([self._vec(t) for t in tokens])
