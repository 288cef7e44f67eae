"""Batched masked nearest-neighbour matching with ORB-SLAM2's gate cascade
(port of ops/matching.py).

Every search is "masked (N1, N2) Hamming matrix -> per-row best and second
best -> threshold, ratio and rotation gates as masks".  Invalid slots carry
``idx = -1`` and ``dist = BIG``.  Where JAX scatters out of range with
``mode="drop"``, these functions scatter into one extra dump slot that is
never read back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1 << 20


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (N1,) int32 matched column per row, -1 if none
    dist: torch.Tensor   # (N1,) int32 best distance (BIG if none)
    mask: torch.Tensor   # (N1,) bool valid match


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row (d1, i1, d2) over a masked (N1, N2) distance matrix; masked
    entries count as BIG and the lowest column wins a tie."""
    d = torch.where(mask, dist, BIG)
    i1 = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, i1[:, None])[:, 0]
    d_no1 = d.scatter(1, i1[:, None], BIG)
    d2 = torch.amin(d_no1, dim=1)
    return d1, i1.to(torch.int32), d2


def nn_match(
    dist: torch.Tensor,
    *,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    extra_mask: Optional[torch.Tensor] = None,
    max_dist: int = 50,
    ratio: float = 1.0,
    mutual: bool = False,
) -> MatchResult:
    """Masked NN matching with threshold + Lowe ratio (+ mutual check:
    the row must also be its column's argmin)."""
    mask = row_valid[:, None] & col_valid[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    d1, i1, d2 = masked_best2(dist, mask)
    ok = _gates(d1, d2, row_valid, max_dist, ratio)
    if mutual:
        d = torch.where(mask, dist, BIG)
        col_best_row = torch.argmin(d, dim=0).to(torch.int32)
        rows = torch.arange(i1.shape[0], dtype=torch.int32, device=i1.device)
        ok = ok & (col_best_row[i1.long()] == rows)
    idx = torch.where(ok, i1, -1)
    return MatchResult(idx=idx, dist=torch.where(ok, d1, BIG), mask=ok)


def _gates(d1, d2, row_valid, max_dist, ratio) -> torch.Tensor:
    """Threshold and Lowe ratio on a row's best-2."""
    ok = row_valid & (d1 <= max_dist)
    if ratio < 1.0:
        ok = ok & (d1.to(torch.float32) < ratio * d2.to(torch.float32))
    return ok


def nn_match_desc(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    *,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    extra_mask: Optional[torch.Tensor] = None,
    max_dist: int = 50,
    ratio: float = 1.0,
) -> MatchResult:
    """``nn_match(hamming(desc_a, desc_b), ..., mutual=False)`` with the
    Hamming matrix never stored: the combined mask goes to
    ``cuda_hamming.hamming_best2`` (the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors).  The mutual check needs each column's
    argmin over the whole matrix, so mutual matchers stay on ``nn_match``."""
    from . import cuda_hamming      # which imports this module

    d1, i1, d2 = cuda_hamming.hamming_best2(desc_a, desc_b,
                                            best2_mask(row_valid, col_valid, extra_mask))
    return best2_result(d1, i1, d2, row_valid, max_dist=max_dist, ratio=ratio)


def best2_mask(row_valid: torch.Tensor, col_valid: torch.Tensor,
               extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (N1, N2) mask ``nn_match_desc`` hands the masked best-2."""
    mask = row_valid[:, None] & col_valid[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    return mask


def best2_result(d1, i1, d2, row_valid: torch.Tensor, *, max_dist: int = 50,
                 ratio: float = 1.0) -> MatchResult:
    """``nn_match_desc``'s matches from the masked best-2's (d1, i1, d2)."""
    ok = _gates(d1, d2, row_valid, max_dist, ratio)
    return MatchResult(idx=torch.where(ok, i1, -1),
                       dist=torch.where(ok, d1, BIG), mask=ok)


def _segment_min(values: torch.Tensor, segments: torch.Tensor,
                 n_segments: int, empty) -> torch.Tensor:
    out = torch.full((n_segments,), empty, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, segments, values, "amin", include_self=False)


def resolve_duplicates(res: MatchResult, n_cols: int) -> MatchResult:
    """Keep only the lowest-distance row per matched column; equal distances
    go to the lowest row index."""
    idx_safe = torch.where(res.mask, res.idx, n_cols).long()
    best_per_col = _segment_min(res.dist, idx_safe, n_cols + 1, BIG)
    keep = res.mask & (res.dist <= best_per_col[idx_safe])
    row_ids = torch.arange(res.idx.shape[0], dtype=torch.int32,
                           device=res.idx.device)
    tie_row = _segment_min(torch.where(keep, row_ids, 1 << 30), idx_safe,
                           n_cols + 1, 1 << 30)
    keep = keep & (tie_row[idx_safe] == row_ids)
    return MatchResult(
        idx=torch.where(keep, res.idx, -1),
        dist=torch.where(keep, res.dist, BIG),
        mask=keep,
    )


def rotation_consistency_mask(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    res: MatchResult,
    histo_length: int = 30,
    top_k: int = 3,
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the top-k histogram bins,
    with the reference's quirk: a bin below 0.1x the largest count is dropped
    even when it is among the top k (ORBmatcher.cc:107-127, 1506-1538)."""
    b_ang = angle_b[torch.clamp(res.idx, 0, angle_b.shape[0] - 1).long()]
    rot = angle_a - b_ang
    rot = torch.where(rot < 0, rot + 360.0, rot)
    factor = histo_length / 360.0
    bin_idx = torch.round(rot * factor).to(torch.int64)
    bin_idx = torch.where(bin_idx == histo_length, 0, bin_idx)
    bin_idx = torch.clamp(bin_idx, 0, histo_length - 1)
    counts = torch.zeros(histo_length + 1, dtype=torch.int32,
                         device=bin_idx.device)
    counts = counts.index_add(
        0, torch.where(res.mask, bin_idx, histo_length),
        res.mask.to(torch.int32),
    )[:histo_length]
    top = torch.sort(counts, descending=True).values[:top_k]
    max1 = top[0]
    kth = top[top_k - 1]
    bin_ok = ((counts >= kth)
              & (counts.to(torch.float32) > 0.1 * max1.to(torch.float32))
              & (counts > 0))
    return res.mask & bin_ok[bin_idx]


def window_mask(uv_query: torch.Tensor, uv_target: torch.Tensor,
                radius) -> torch.Tensor:
    """|du|, |dv| within the per-row radius (GetFeaturesInArea as a mask)."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_query.device)
    r = r.expand(uv_query.shape[0])
    du = torch.abs(uv_query[:, 0:1] - uv_target[None, :, 0])
    dv = torch.abs(uv_query[:, 1:2] - uv_target[None, :, 1])
    return (du <= r[:, None]) & (dv <= r[:, None])


def octave_band_mask(level_query: torch.Tensor, level_target: torch.Tensor,
                     min_offset: int, max_offset: int) -> torch.Tensor:
    """Target level within [q + min_offset, q + max_offset]."""
    lq = level_query[:, None]
    lt = level_target[None, :]
    return (lt >= lq + min_offset) & (lt <= lq + max_offset)
