"""Visual vocabulary for place recognition (port of place/vocab.py).

A flat vocabulary of W binary cell centres in place of DBoW2's k=10/L=6
tree: a descriptor's word is the centre nearest in Hamming distance, all of
them from one ±1 float32 product (the 256-term sums of ±1 are integers, so
the distances are exact, and the lowest word wins a tie as ``jnp.argmin``
gives it).  A keyframe's signature is its L1-normalized tf-idf histogram
(DBoW2's TF_IDF weighting with L1 scoring).  Training is k-medians in
Hamming space with bitwise-majority centres (FORB::meanValue), started
from a random sample.

Words are ``(W, 8) int32``, the JAX package's ``uint32`` bits viewed as
signed, like every descriptor bank of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.descriptors import (
    DESC_BITS, majority_descriptor, unpack_bits, unpack_pm1,
)


class Vocabulary(NamedTuple):
    words: torch.Tensor      # (W, 8) int32 cell centres
    words_pm1: torch.Tensor  # (W, 256) ±1 float32 planes of the centres
    idf: torch.Tensor        # (W,) inverse document frequency

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def make_vocabulary(words: torch.Tensor, idf: torch.Tensor) -> Vocabulary:
    return Vocabulary(words=words, words_pm1=unpack_pm1(words), idf=idf)


def _as_words(descriptors: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(descriptors)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected uint32 or int32 descriptor words, got {a.dtype}")
    return a.view(np.int32)


def _distances(desc: torch.Tensor, words_pm1: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors against (W, 256) ±1 centres -> (N, W) Hamming."""
    return ((DESC_BITS - unpack_pm1(desc) @ words_pm1.T) * 0.5).to(torch.int32)


def train_vocabulary(descriptors: np.ndarray, n_words: int = 1024, iters: int = 8,
                     seed: int = 0, device="cpu") -> Vocabulary:
    """k-medians of (N, 8) packed descriptors into ``n_words`` cells, then
    the idf of the training corpus (TemplatedVocabulary::setWeights).  The
    same seed draws the same starting centres as the JAX package."""
    rng = np.random.default_rng(seed)
    desc = _as_words(descriptors)
    n = desc.shape[0]
    centers = torch.from_numpy(desc[rng.choice(n, n_words, replace=n < n_words)].copy()).to(device)
    desc_t = torch.from_numpy(desc.copy()).to(device)
    bits = unpack_bits(desc_t).to(torch.int32)                     # (N, 256)
    for _ in range(iters):
        assign = torch.argmin(_distances(desc_t, unpack_pm1(centers)), dim=1)
        counts = torch.zeros((n_words, DESC_BITS), dtype=torch.int32,
                             device=device).index_add_(0, assign, bits)
        sizes = torch.zeros(n_words, dtype=torch.int32, device=device).index_add_(
            0, assign, torch.ones(n, dtype=torch.int32, device=device))
        new = majority_descriptor(counts, torch.clamp(sizes, min=1)[:, None])
        centers = torch.where((sizes == 0)[:, None], centers, new)   # empty: keep
    words_pm1 = unpack_pm1(centers)
    assign = torch.argmin(_distances(desc_t, words_pm1), dim=1).cpu().numpy()
    df = np.bincount(assign, minlength=n_words).astype(np.float32)
    idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32)
    return Vocabulary(words=centers, words_pm1=words_pm1,
                      idf=torch.from_numpy(idf).to(device))


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    """The JAX package's npz layout: ``words`` as uint32, ``idf``."""
    np.savez_compressed(path, words=vocab.words.cpu().numpy().view(np.uint32),
                        idf=vocab.idf.cpu().numpy())


def load_vocabulary(path: str, device="cpu") -> Vocabulary:
    z = np.load(path)
    return make_vocabulary(torch.from_numpy(_as_words(z["words"]).copy()).to(device),
                           torch.from_numpy(np.asarray(z["idf"], np.float32)).to(device))


def assign_words(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors -> (N,) int32 word ids, -1 for invalid slots."""
    w = torch.argmin(_distances(desc, vocab.words_pm1), dim=1).to(torch.int32)
    return torch.where(valid, w, -1)


def bow_vector(vocab: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Word ids (N,) -> L1-normalized tf-idf signature (W,) (TemplatedVocabulary
    transform + BowVector::normalize).  The counts are integers, so tf is the
    JAX one-hot sum to the bit; ``index_add_`` reads nothing back, which
    ``bincount`` would (its length)."""
    W = vocab.n_words
    idx = torch.where(word_ids >= 0, word_ids, W).long()
    tf = torch.zeros(W + 1, dtype=torch.float32, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device))[:W]
    v = tf * vocab.idf
    s = v.sum()
    return v / torch.where(s > 0, s, 1.0)


def bow_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L1 similarity in [0, 1] of L1-normalized signatures (DBoW2 L1Scoring):
    ``1 - |a - b|_1 / 2``; a (W,) against b (..., W)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)
