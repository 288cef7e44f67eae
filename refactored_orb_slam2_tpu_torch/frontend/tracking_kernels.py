"""Per-frame tracking searches (port of frontend/tracking_kernels.py).

- ``match_motion_model``  = ORBmatcher::SearchByProjection(Frame, LastFrame)
  (ORBmatcher.cc:1247-1383);
- ``match_reference_kf``  = the matching of TrackReferenceKeyFrame
  (Tracking.cc:681-719);
- ``match_kf_points_by_projection`` = the relocalization rescue search,
  ORBmatcher::SearchByProjection(Frame, KeyFrame, sAlreadyFound, th, ORBdist)
  (ORBmatcher.cc:1385-1504), through ``cuda_hamming.hamming_best2``;
- ``match_vo_points``     = the temporal points of localization-only mode
  (UpdateLastFrame, Tracking.cc:724-778) matched like the motion model;
- ``select_local_points`` = Tracking::UpdateLocalPoints + Frame::isInFrustum
  (Tracking.cc:1090-1113, Frame.cc:284-339) with a static top-k budget;
- ``match_local_points``  = ORBmatcher::SearchByProjection(Frame, vector)
  (ORBmatcher.cc:45-135), always through ``cuda_hamming.window_match``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..models.map_ops import set_rows
from ..models.map_state import predict_scale
from ..ops import cuda_hamming
from ..ops import matching as M
from ..ops.descriptors import hamming
from ..ops.image import scale_table


class ProjMatchResult(NamedTuple):
    pt_idx: torch.Tensor     # (N,) map-point slot matched to each feature (-1)
    n_matches: torch.Tensor  # () int32


def _radius_scale(scale_factors: np.ndarray, level: torch.Tensor) -> torch.Tensor:
    """scale_factors[clip(level)] gathered on the device."""
    table = scale_table(tuple(float(v) for v in scale_factors), level.device)
    return table[torch.clamp(level, 0, len(scale_factors) - 1).long()]


def project_in_image(cam, pc: torch.Tensor):
    """Camera-frame points -> (u, v, depth > 1e-3, inside the image)."""
    z_ok = pc[:, 2] > 1e-3
    z_safe = torch.where(z_ok, pc[:, 2], 1.0)
    u = cam.fx * pc[:, 0] / z_safe + cam.cx
    v = cam.fy * pc[:, 1] / z_safe + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return u, v, z_ok, in_img


def _scatter_to_features(base: torch.Tensor, res: M.MatchResult,
                         row_pt: torch.Tensor) -> torch.Tensor:
    """``base`` with feature ``res.idx[row]`` set to ``row_pt[row]`` for every
    matched row (columns are unique after resolve_duplicates)."""
    col = torch.where(res.mask, res.idx, base.shape[0])
    return set_rows(base, col, torch.where(res.mask, row_pt, -1).to(torch.int32))


def match_motion_model(
    cam,
    Tcw: torch.Tensor,
    frame,                      # FrameData
    last_pt: torch.Tensor,      # (N,) last frame's matched point slots (-1)
    last_octave: torch.Tensor,  # (N,) last frame keypoint octaves
    pt_pos: torch.Tensor,       # (P, 3)
    pt_valid: torch.Tensor,     # (P,)
    pt_desc: torch.Tensor,      # (P, 8)
    last_angle: torch.Tensor,   # (N,) degrees
    *,
    th: float,
    scale_factors: np.ndarray,
    nn_max_dist: int = 100,
    nn_ratio: float = 0.9,
) -> ProjMatchResult:
    """Project the last frame's tracked points with the predicted pose and
    match them into the current frame (rows = last-frame features, columns =
    current features); returns the point assigned to each current feature."""
    lp = torch.clamp(last_pt, min=0).long()
    has_pt = (last_pt >= 0) & pt_valid[lp]
    pw = pt_pos[lp]
    u, v, z_ok, in_img = project_in_image(cam, se3.transform(Tcw, pw))
    uv = torch.stack([u, v], dim=-1)
    row_valid = has_pt & z_ok & in_img

    radius = th * _radius_scale(scale_factors, last_octave)
    geo = M.window_mask(uv, frame.xy, radius)
    geo = geo & M.octave_band_mask(last_octave, frame.octave, -1, 1)

    dist = hamming(pt_desc[lp], frame.desc)
    res = M.nn_match(dist, row_valid=row_valid, col_valid=frame.valid,
                     extra_mask=geo, max_dist=nn_max_dist, ratio=nn_ratio,
                     mutual=True)
    res = M.resolve_duplicates(res, frame.n_slots)
    # rotation-consistency histogram (ORBmatcher.cc:1336-1378)
    keep = M.rotation_consistency_mask(last_angle, frame.angle, res)
    res = M.MatchResult(idx=torch.where(keep, res.idx, -1),
                        dist=torch.where(keep, res.dist, M.BIG), mask=keep)
    base = torch.full((frame.n_slots,), -1, dtype=torch.int32, device=pw.device)
    return ProjMatchResult(pt_idx=_scatter_to_features(base, res, last_pt),
                           n_matches=res.mask.sum(dtype=torch.int32))


def match_reference_kf(
    frame,                      # FrameData
    kf_desc: torch.Tensor,      # (N, 8) reference keyframe descriptors
    kf_pt_idx: torch.Tensor,    # (N,) reference keyframe's point slots (-1)
    kf_feat_valid: torch.Tensor,
    kf_angle: torch.Tensor,     # (N,) degrees
    pt_valid: torch.Tensor,     # (P,)
    *,
    nn_ratio: float = 0.7,      # matcher(0.7, true) (Tracking.cc:688)
    max_dist: int = 50,         # TH_LOW (SearchByBoW, ORBmatcher.cc:198)
) -> ProjMatchResult:
    """Associate the frame's features with the reference keyframe's
    landmark-bearing features by descriptor distance alone: the full masked
    Hamming matrix in place of SearchByBoW's vocabulary buckets, with its
    gates (TH_LOW, ratio, mutual best, rotation histogram, one-to-one)."""
    has_pt = ((kf_pt_idx >= 0) & kf_feat_valid
              & pt_valid[torch.clamp(kf_pt_idx, min=0).long()])
    res = M.nn_match(hamming(kf_desc, frame.desc), row_valid=has_pt,
                     col_valid=frame.valid, max_dist=max_dist, ratio=nn_ratio,
                     mutual=True)
    res = M.resolve_duplicates(res, frame.n_slots)
    keep = M.rotation_consistency_mask(kf_angle, frame.angle, res)
    res = M.MatchResult(idx=torch.where(keep, res.idx, -1),
                        dist=torch.where(keep, res.dist, M.BIG), mask=keep)
    base = torch.full((frame.n_slots,), -1, dtype=torch.int32, device=kf_desc.device)
    return ProjMatchResult(pt_idx=_scatter_to_features(base, res, kf_pt_idx),
                           n_matches=res.mask.sum(dtype=torch.int32))


def match_kf_points_by_projection(
    cam,
    Tcw: torch.Tensor,
    frame,                        # FrameData
    kf_pt_idx: torch.Tensor,      # (N,) candidate keyframe's point slots (-1)
    kf_feat_valid: torch.Tensor,  # (N,)
    kf_angle: torch.Tensor,       # (N,) degrees (rotation histogram)
    pt_pos: torch.Tensor,         # (P, 3)
    pt_valid: torch.Tensor,       # (P,)
    pt_desc: torch.Tensor,        # (P, 8)
    pt_max_dist: torch.Tensor,    # (P,) scale band for the octave prediction
    existing_pt: torch.Tensor,    # (N,) current frame's matches (kept, excluded)
    *,
    th: float,
    max_dist: int,
    scale_factors: np.ndarray,
    scale_factor: float,
    n_levels: int,
) -> ProjMatchResult:
    """Project the candidate keyframe's landmarks that the frame has not
    matched yet with the current pose estimate, and match them into the
    frame's free features: window th x scale^predicted level, octave band
    [pred - 1, pred + 1], distance <= ``max_dist``, one row per column,
    rotation histogram.  Rows are the keyframe's feature slots, columns the
    frame's; returns ``existing_pt`` with the new associations merged in.

    The masked best-2 runs in ``matching.nn_match_desc``, so on the card the
    masked CUDA kernel does it."""
    P = pt_pos.shape[0]
    already = set_rows(torch.zeros(P, dtype=torch.bool, device=pt_pos.device),
                       torch.where(existing_pt >= 0, existing_pt, P), True)
    kp = torch.clamp(kf_pt_idx, min=0).long()
    has_pt = kf_feat_valid & (kf_pt_idx >= 0) & pt_valid[kp] & ~already[kp]
    pw = pt_pos[kp]
    u, v, z_ok, in_img = project_in_image(cam, se3.transform(Tcw, pw))
    uv = torch.stack([u, v], dim=-1)
    row_valid = has_pt & z_ok & in_img

    center = se3.translation(se3.inv(Tcw))
    pred = predict_scale(torch.linalg.norm(pw - center, dim=-1), pt_max_dist[kp],
                         scale_factor, n_levels)
    radius = th * _radius_scale(scale_factors, pred)
    geo = M.window_mask(uv, frame.xy, radius)
    geo = geo & M.octave_band_mask(pred, frame.octave, -1, 1)

    res = M.nn_match_desc(pt_desc[kp], frame.desc, row_valid=row_valid,
                          col_valid=frame.valid & (existing_pt < 0), extra_mask=geo,
                          max_dist=max_dist)
    res = M.resolve_duplicates(res, frame.n_slots)
    keep = M.rotation_consistency_mask(kf_angle, frame.angle, res)
    res = M.MatchResult(idx=torch.where(keep, res.idx, -1),
                        dist=torch.where(keep, res.dist, M.BIG), mask=keep)
    return ProjMatchResult(pt_idx=_scatter_to_features(existing_pt, res, kf_pt_idx),
                           n_matches=res.mask.sum(dtype=torch.int32))


class VoMatchResult(NamedTuple):
    pw: torch.Tensor         # (N, 3) temporal 3D point per current feature
    mask: torch.Tensor       # (N,) matched to a temporal point
    n_matches: torch.Tensor  # () int32


def match_vo_points(
    cam,
    Tcw_pred: torch.Tensor,     # predicted pose of the current frame
    frame,                      # current FrameData
    last_xy: torch.Tensor,      # (N, 2) last frame keypoints
    last_depth: torch.Tensor,   # (N,) last frame per-feature depth (<= 0 none)
    last_valid: torch.Tensor,   # (N,)
    last_pt: torch.Tensor,      # (N,) last frame map-point slots (-1)
    last_octave: torch.Tensor,
    last_angle: torch.Tensor,
    last_desc: torch.Tensor,    # (N, 8)
    Tcw_last: torch.Tensor,     # last frame pose
    *,
    th: float,
    scale_factors: np.ndarray,
    nn_max_dist: int = 100,
    nn_ratio: float = 0.9,
) -> VoMatchResult:
    """Localization-only visual-odometry matching (``mbVO``,
    Tracking.cc:299-361): unproject the last frame's *unmatched* depth
    features into temporal 3D points and match them into the current frame,
    so tracking survives unmapped regions with the map frozen."""
    has_depth = last_valid & (last_depth > 0) & (last_pt < 0)
    z = torch.where(has_depth, last_depth, 1.0)
    xc = (last_xy[:, 0] - cam.cx) / cam.fx * z
    yc = (last_xy[:, 1] - cam.cy) / cam.fy * z
    pw = se3.transform(se3.inv(Tcw_last), torch.stack([xc, yc, z], dim=-1))   # (N, 3)

    u, v, z_ok, in_img = project_in_image(cam, se3.transform(Tcw_pred, pw))
    uv = torch.stack([u, v], dim=-1)
    row_valid = has_depth & z_ok & in_img

    radius = th * _radius_scale(scale_factors, last_octave)
    geo = M.window_mask(uv, frame.xy, radius)
    geo = geo & M.octave_band_mask(last_octave, frame.octave, -1, 1)
    res = M.nn_match(hamming(last_desc, frame.desc), row_valid=row_valid,
                     col_valid=frame.valid, extra_mask=geo, max_dist=nn_max_dist,
                     ratio=nn_ratio, mutual=True)
    res = M.resolve_duplicates(res, frame.n_slots)
    keep = M.rotation_consistency_mask(last_angle, frame.angle, res)

    # scatter the temporal points onto the current features; rejected rows go
    # to the dump row, and a column keeps its last row as in JAX
    col = torch.where(keep, res.idx, frame.n_slots)
    out_pw = set_rows(torch.zeros((frame.n_slots, 3), dtype=pw.dtype, device=pw.device),
                      col, pw)
    out_mask = set_rows(torch.zeros(frame.n_slots, dtype=torch.bool, device=pw.device),
                        col, keep)
    return VoMatchResult(pw=out_pw, mask=out_mask,
                         n_matches=keep.sum(dtype=torch.int32))


class LocalPoints(NamedTuple):
    idx: torch.Tensor         # (B,) point slots (-1 pad)
    valid: torch.Tensor       # (B,)
    uv: torch.Tensor          # (B, 2) projected pixel coords
    pred_level: torch.Tensor  # (B,) predicted octave
    view_cos: torch.Tensor    # (B,)


def select_local_points(
    cam,
    Tcw: torch.Tensor,
    pt_pos: torch.Tensor,
    pt_valid: torch.Tensor,
    pt_normal: torch.Tensor,
    pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor,
    already_matched: torch.Tensor,   # (P,) bool — tracked this frame, skip
    *,
    budget: int,
    scale_factor: float,
    n_levels: int,
) -> LocalPoints:
    """Frustum-cull the point bank (positive depth, in image, distance in
    [0.8 min, 1.2 max], viewing cos > 0.5) and keep the ``budget`` nearest.

    The top-k is a stable descending sort: equal scores keep the lowest slot
    first, as ``lax.top_k`` does."""
    u, v, z_ok, in_img = project_in_image(cam, se3.transform(Tcw, pt_pos))
    center = se3.translation(se3.inv(Tcw))
    po = pt_pos - center
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    view_cos = torch.sum(po * pt_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    ok = pt_valid & z_ok & in_img & dist_ok & (view_cos > 0.5) & ~already_matched
    score = torch.where(ok, -dist, float("-inf"))
    top_score, top_idx = torch.sort(score, descending=True, stable=True)
    top_score, top_idx = top_score[:budget], top_idx[:budget]
    sel_valid = torch.isfinite(top_score)
    pred = predict_scale(dist[top_idx], pt_max_dist[top_idx], scale_factor, n_levels)
    return LocalPoints(
        idx=torch.where(sel_valid, top_idx, -1).to(torch.int32),
        valid=sel_valid,
        uv=torch.stack([u[top_idx], v[top_idx]], dim=-1),
        pred_level=pred,
        view_cos=view_cos[top_idx],
    )


def match_local_points(
    frame,
    local: LocalPoints,
    pt_desc: torch.Tensor,
    existing_pt: torch.Tensor,   # (N,) current per-feature match (kept)
    *,
    th: float,
    scale_factors: np.ndarray,
    nn_ratio: float = 0.8,
    nn_max_dist: int = 100,      # TH_HIGH gate (ORBmatcher.cc:109)
) -> ProjMatchResult:
    """Match the selected local points against the frame's unmatched
    features: radius (2.5 if viewCos > 0.998 else 4.0) * th * scale^pred,
    octave band [pred - 1, pred], TH_HIGH and ratio 0.8.

    Distances, masks and the best-2 come from ``cuda_hamming.window_match``
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors).
    The JAX package pads both sides to 128-row tiles first
    (``frontend/pallas_glue.py``); the CUDA kernel masks its own ragged
    edges, so that glue has no counterpart here.
    """
    base_r = torch.where(local.view_cos > 0.998, 2.5, 4.0)
    radius = base_r * th * _radius_scale(scale_factors, local.pred_level)
    col_free = frame.valid & (existing_pt < 0)
    d1, i1, d2 = cuda_hamming.window_match(
        pt_desc[torch.clamp(local.idx, min=0).long()], frame.desc,
        local.uv, frame.xy, radius, local.pred_level, frame.octave,
        local.valid, col_free, (-1, 0),
    )
    ok = local.valid & (d1 <= nn_max_dist)
    ok = ok & (d1.to(torch.float32) < nn_ratio * d2.to(torch.float32))
    res = M.MatchResult(idx=torch.where(ok, i1, -1),
                        dist=torch.where(ok, d1, M.BIG), mask=ok)
    res = M.resolve_duplicates(res, frame.n_slots)
    return ProjMatchResult(pt_idx=_scatter_to_features(existing_pt, res, local.idx),
                           n_matches=res.mask.sum(dtype=torch.int32))
