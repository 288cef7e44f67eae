"""Keyframe database: loop and relocalization candidate retrieval (port of
place/keyframe_db.py, which replaces KeyFrameDatabase.cc).

No inverted index: every keyframe's tf-idf signature lives in a dense
``(K, W)`` float32 bank on the device (512 x 4096 = 8 MiB at the bench
configuration) and a query is one masked reduction against it.  The
candidate logic is the reference's:

- ``detect_loop_candidates`` (KeyFrameDatabase.cc:72-193): leave out the
  query's covisible neighbours, require a score of at least minScore (the
  lowest score of the query against its connected neighbours), accumulate
  scores over covisibility groups, return the best member of every group
  above 0.75 x the best accumulated score;
- ``detect_reloc_candidates`` (KeyFrameDatabase.cc:195-304): the same
  without the minScore gate, or over the scores alone without a
  covisibility matrix.

Every function runs on the device and reads nothing back; ``lax.top_k``
becomes a stable descending sort, so equal values keep the lowest slot
first, as ``lax.top_k`` does.
"""

from __future__ import annotations

import torch

from .vocab import Vocabulary, assign_words, bow_score, bow_vector


class KeyFrameDB:
    """The signature bank and its valid mask, updated in place on the
    vocabulary's device."""

    def __init__(self, vocab: Vocabulary, max_keyframes: int):
        self.vocab = vocab
        dev = vocab.words.device
        self.bow = torch.zeros((max_keyframes, vocab.n_words), dtype=torch.float32, device=dev)
        self.valid = torch.zeros(max_keyframes, dtype=torch.bool, device=dev)

    def add(self, kf_slot: int, desc: torch.Tensor, feat_valid: torch.Tensor) -> torch.Tensor:
        """Word assignment, signature and bank update of one keyframe."""
        v = self.signature_of(desc, feat_valid)
        self.bow[kf_slot] = v
        # fill_, not item assignment: a Python scalar into a CUDA tensor
        # synchronizes
        self.valid[kf_slot:kf_slot + 1].fill_(True)
        return v

    def erase(self, kf_slot: int) -> None:
        self.valid[kf_slot:kf_slot + 1].fill_(False)

    def signature_of(self, desc: torch.Tensor, feat_valid: torch.Tensor) -> torch.Tensor:
        return bow_vector(self.vocab, assign_words(self.vocab, desc, feat_valid))

    def scores(self, query_bow: torch.Tensor) -> torch.Tensor:
        """(K,) L1 similarity of the query against every stored keyframe,
        -1 for an empty slot."""
        return torch.where(self.valid, bow_score(query_bow, self.bow), -1.0)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: equal values keep the lower index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_accumulate(scores, eligible, covis, top_n: int = 10, min_weight: int = 15):
    """Covisibility-group score accumulation (KeyFrameDatabase.cc:120-193):
    every eligible keyframe adds the scores of its top ``top_n`` covisible
    neighbours (weight >= ``min_weight``) that are eligible too, and records
    the group's best-scoring member, the keyframe the reference returns.
    Returns (acc (K,), best_member (K,) int32, best_member_score (K,))."""
    K = scores.shape[0]
    w, nb = _top_k(covis, min(top_n, K))                           # (K, n)
    s_e = torch.where(eligible, scores, 0.0)
    nb_scores = torch.where(w >= min_weight, s_e[nb], 0.0)
    acc = s_e + nb_scores.sum(dim=1)
    member_scores = torch.cat([s_e[:, None], nb_scores], dim=1)
    member_idx = torch.cat([torch.arange(K, device=nb.device)[:, None], nb], dim=1)
    best = torch.argmax(member_scores, dim=1, keepdim=True)        # first of equals
    return (acc, torch.gather(member_idx, 1, best)[:, 0].to(torch.int32),
            torch.gather(member_scores, 1, best)[:, 0])


def _best_of_groups(acc, eligible, best_member, best_member_score, K: int,
                    max_candidates: int):
    """Keep the groups with an accumulated score >= 0.75 x the best and
    return each kept group's best member once, by its best member score
    (KeyFrameDatabase.cc:160-193).  Returns (slots (C,) int32 with -1 pad,
    scores (C,))."""
    acc_e = torch.where(eligible, acc, -1.0)
    keep = eligible & (acc_e >= 0.75 * acc_e.max()) & (acc_e > 0)
    # .at[].max(mode="drop"): the dropped rows go to slot K, sliced off
    per_kf = torch.full((K + 1,), -1.0, dtype=acc.dtype, device=acc.device).scatter_reduce(
        0, torch.where(keep, best_member.long(), K),
        torch.where(keep, best_member_score, -1.0), "amax")[:K]
    top_s, top_i = _top_k(per_kf, max_candidates)
    return torch.where(top_s > 0, top_i, -1).to(torch.int32), top_s


def detect_loop_candidates(db: KeyFrameDB, query_bow: torch.Tensor, query_kf: int,
                           covis: torch.Tensor, *, max_candidates: int = 8):
    """Loop candidates for keyframe ``query_kf`` (KeyFrameDatabase.cc:72-193,
    LoopClosing.cc:112-129).  minScore comes from the connected neighbours
    (weight >= 15, GetVectorCovisibleKeyFrames): barely overlapping
    keyframes would drag it down to the noise.  Returns (slots (C,),
    scores (C,)) with -1 padding."""
    K = db.bow.shape[0]
    scores = db.scores(query_bow)
    row = covis[query_kf]
    pool = torch.where(row >= 15, scores, float("inf"))
    min_score = torch.clamp(pool.min(), max=1.0)
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    not_query = torch.arange(K, device=scores.device) != query_kf
    eligible = (db.valid & (row <= 0) & not_query
                & (scores >= torch.clamp(min_score, min=0.0)) & (scores > 0))
    acc, best_member, bm_score = _group_accumulate(scores, eligible, covis)
    return _best_of_groups(acc, eligible, best_member, bm_score, K, max_candidates)


def detect_reloc_candidates(db: KeyFrameDB, query_bow: torch.Tensor,
                            covis: torch.Tensor | None = None, *, max_candidates: int = 5):
    """Relocalization candidates for a lost frame (KeyFrameDatabase.cc:
    195-304): the covisibility-group form, or without ``covis`` the flat
    form (every keyframe within 0.75 x the best score)."""
    K = db.bow.shape[0]
    scores = db.scores(query_bow)
    eligible = db.valid & (scores > 0)
    if covis is None:
        s = torch.where(eligible, scores, -1.0)
        keep = eligible & (s >= 0.75 * s.max())
        top_s, top_i = _top_k(torch.where(keep, s, -1.0), max_candidates)
        return torch.where(top_s > 0, top_i, -1).to(torch.int32), top_s
    acc, best_member, bm_score = _group_accumulate(scores, eligible, covis)
    return _best_of_groups(acc, eligible, best_member, bm_score, K, max_candidates)
