"""The SLAM map as fixed-shape tensor banks (port of models/map_state.py).

K keyframe slots x N feature slots, P point slots x O observation slots;
invalid slots are masked, never read.  Update functions return a new
``MapState`` and leave the old one untouched, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.descriptors import unpack_pm1


@dataclass
class MapState:
    """Device-resident map banks (same fields as the JAX ``MapState``)."""

    # keyframe bank
    kf_pose: torch.Tensor        # (K, 4, 4) Tcw
    kf_valid: torch.Tensor       # (K,) bool
    kf_frame_id: torch.Tensor    # (K,) int32
    kf_xy: torch.Tensor          # (K, N, 2) float32 undistorted keypoints
    kf_uvr: torch.Tensor         # (K, N, 3) float32 (u, v, uR)
    kf_octave: torch.Tensor      # (K, N) int32
    kf_angle: torch.Tensor       # (K, N) float32 degrees
    kf_desc: torch.Tensor        # (K, N, 8) int32 packed rBRIEF
    kf_feat_valid: torch.Tensor  # (K, N) bool
    kf_point_idx: torch.Tensor   # (K, N) int32 map-point slot (-1)
    # map-point bank
    pt_pos: torch.Tensor         # (P, 3)
    pt_valid: torch.Tensor       # (P,) bool
    pt_desc: torch.Tensor        # (P, 8) int32 distinctive descriptor
    pt_normal: torch.Tensor      # (P, 3) mean viewing direction
    pt_min_dist: torch.Tensor    # (P,)
    pt_max_dist: torch.Tensor    # (P,)
    pt_ref_kf: torch.Tensor      # (P,) int32
    pt_first_kf: torch.Tensor    # (P,) int32
    pt_visible: torch.Tensor     # (P,) int32 times predicted visible
    pt_found: torch.Tensor       # (P,) int32 times matched
    pt_obs_kf: torch.Tensor      # (P, O) int32 keyframe slot (-1 empty)
    pt_obs_feat: torch.Tensor    # (P, O) int32 feature slot in that keyframe
    # graph
    kf_parent: torch.Tensor      # (K,) int32 spanning-tree parent (-1 root)
    kf_loop_edges: torch.Tensor  # (K, 8) int32 loop edge targets (-1 empty)

    @property
    def capacity(self):
        K, N = self.kf_feat_valid.shape
        P, O = self.pt_obs_kf.shape
        return K, N, P, O

    def replace(self, **changes) -> "MapState":
        return dataclasses.replace(self, **changes)


def create_empty(cfg, n_feat_slots: int, device) -> MapState:
    """Empty banks at the capacities of a ``utils.config.MapConfig``."""
    K, P, O = cfg.max_keyframes, cfg.max_points, cfg.max_obs_per_point
    N = n_feat_slots
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_pose=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy=full((K, N, 2), 0.0, f32),
        kf_uvr=full((K, N, 3), -1.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_point_idx=full((K, N), -1, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 0.0, f32),
        pt_ref_kf=full((P,), -1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        pt_obs_kf=full((P, O), -1, i32),
        pt_obs_feat=full((P, O), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_loop_edges=full((K, 8), -1, i32),
    )


def _kf_centers(state: MapState) -> torch.Tensor:
    R_wc = state.kf_pose[:, :3, :3].transpose(1, 2)
    return -(R_wc @ state.kf_pose[:, :3, 3:])[..., 0]          # (K, 3)


_STATS_CHUNK = 2048


def update_point_stats(state: MapState, scale_factor: float,
                       n_levels: int) -> MapState:
    """Recompute distinctive descriptor, normal and distance band of every
    valid point from its observations (MapPoint::ComputeDistinctive-
    Descriptors / UpdateNormalAndDepth, MapPoint.cc:229-391)."""
    P, O = state.pt_obs_kf.shape
    kfc = torch.clamp(state.pt_obs_kf, min=0).long()
    ftc = torch.clamp(state.pt_obs_feat, min=0).long()
    obs_ok = (state.pt_obs_kf >= 0) & state.pt_valid[:, None] & state.kf_valid[kfc]

    descs = state.kf_desc[kfc, ftc]                            # (P, O, 8)
    # the observation with the least summed Hamming distance to the others
    # (the reference takes the median; the sum is the same minimiser for
    # typical O), chunked over P so the (chunk, O, 256) planes stay small
    best_parts = []
    for s in range(0, P, _STATS_CHUNK):
        d, ok = descs[s:s + _STATS_CHUNK], obs_ok[s:s + _STATS_CHUNK]
        pm1 = unpack_pm1(d)                                    # (c, O, 256)
        ham = (256.0 - pm1 @ pm1.transpose(1, 2)) * 0.5        # exact integers
        pair_ok = ok[:, :, None] & ok[:, None, :]
        ham_sum = torch.where(ok, torch.where(pair_ok, ham, 0.0).sum(dim=2), 1e9)
        best_parts.append(torch.argmin(ham_sum, dim=1))
    best_obs = torch.cat(best_parts)
    rows = torch.arange(P, device=descs.device)
    has_obs = torch.any(obs_ok, dim=1)
    pt_desc = torch.where(has_obs[:, None], descs[rows, best_obs], state.pt_desc)

    # normals: mean of unit vectors from the observing camera centres
    centers = _kf_centers(state)
    vec = state.pt_pos[:, None, :] - centers[kfc]              # (P, O, 3)
    n = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)
    normal = torch.where(obs_ok[..., None], n, 0.0).sum(dim=1)
    cnt = torch.clamp(obs_ok.sum(dim=1), min=1)
    normal = normal / cnt[:, None]
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(nn < 1e-12, 1.0, nn)
    pt_normal = torch.where(has_obs[:, None], normal, state.pt_normal)

    # distance band from the distinctive observation's octave
    # (MapPoint.cc:365-380)
    ref_kf = kfc[rows, best_obs]
    ref_ft = ftc[rows, best_obs]
    dist_ref = torch.linalg.norm(state.pt_pos - centers[ref_kf], dim=-1)
    level = state.kf_octave[ref_kf, ref_ft]
    max_dist = dist_ref * torch.pow(scale_factor, level.to(torch.float32))
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return state.replace(
        pt_desc=pt_desc, pt_normal=pt_normal,
        pt_min_dist=torch.where(has_obs, min_dist, state.pt_min_dist),
        pt_max_dist=torch.where(has_obs, max_dist, state.pt_max_dist),
    )


def update_point_stats_subset(state: MapState, pt_idx: torch.Tensor,
                              scale_factor: float, n_levels: int) -> MapState:
    """``update_point_stats`` for the point slots in ``pt_idx`` ((M,) int32;
    negatives are padding): local mapping refreshes the points of the
    current keyframe, whose observation sets it just changed."""
    from .map_ops import set_rows

    P, O = state.pt_obs_kf.shape
    M = pt_idx.shape[0]
    row_ok = (pt_idx >= 0) & (pt_idx < P)
    pi = torch.clamp(pt_idx, 0, P - 1).long()
    obs_kf = state.pt_obs_kf[pi]                               # (M, O)
    kfc = torch.clamp(obs_kf, min=0).long()
    ftc = torch.clamp(state.pt_obs_feat[pi], min=0).long()
    obs_ok = ((obs_kf >= 0) & state.pt_valid[pi][:, None] & state.kf_valid[kfc]
              & row_ok[:, None])
    descs = state.kf_desc[kfc, ftc]                            # (M, O, 8)
    pm1 = unpack_pm1(descs)
    ham = (256.0 - pm1 @ pm1.transpose(1, 2)) * 0.5            # exact integers
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    ham_sum = torch.where(obs_ok, torch.where(pair_ok, ham, 0.0).sum(dim=2), 1e9)
    best_obs = torch.argmin(ham_sum, dim=1)
    rows = torch.arange(M, device=pi.device)
    new_desc = descs[rows, best_obs]
    has_obs = torch.any(obs_ok, dim=1) & row_ok

    centers = _kf_centers(state)
    pos = state.pt_pos[pi]
    vec = pos[:, None, :] - centers[kfc]                       # (M, O, 3)
    n = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)
    normal = torch.where(obs_ok[..., None], n, 0.0).sum(dim=1)
    cnt = torch.clamp(obs_ok.sum(dim=1), min=1)
    normal = normal / cnt[:, None]
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(nn < 1e-12, 1.0, nn)

    ref_kf = kfc[rows, best_obs]
    ref_ft = ftc[rows, best_obs]
    dist_ref = torch.linalg.norm(pos - centers[ref_kf], dim=-1)
    level = state.kf_octave[ref_kf, ref_ft]
    max_dist = dist_ref * torch.pow(scale_factor, level.to(torch.float32))
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    tgt = torch.where(has_obs, pi, P)                          # drop pad rows
    return state.replace(
        pt_desc=set_rows(state.pt_desc, tgt, new_desc),
        pt_normal=set_rows(state.pt_normal, tgt, normal),
        pt_min_dist=set_rows(state.pt_min_dist, tgt, min_dist),
        pt_max_dist=set_rows(state.pt_max_dist, tgt, max_dist),
    )


_COVIS_CHUNK = 8192


def covisibility_matrix(state: MapState) -> torch.Tensor:
    """(K, K) int32 weights: the number of map points both keyframes see
    (KeyFrame::UpdateConnections, KeyFrame.cc:268-354), as B^T B of the
    point-by-keyframe incidence B, summed over point chunks.  B holds
    integer counts, so the float32 products are exact in any order."""
    K, N, P, O = state.capacity
    kf = state.pt_obs_kf
    kfc = torch.where((kf >= 0) & state.pt_valid[:, None], kf, K).long()
    W = torch.zeros((K, K), dtype=torch.float32, device=kf.device)
    for s in range(0, P, _COVIS_CHUNK):
        chunk = kfc[s:s + _COVIS_CHUNK]
        B = torch.zeros((chunk.shape[0], K + 1), dtype=torch.int32, device=kf.device)
        B = B.scatter_add_(1, chunk, torch.ones_like(chunk, dtype=torch.int32))
        B = B[:, :K].to(torch.float32)
        W = W + B.T @ B
    W = W.to(torch.int32)
    return W * (1 - torch.eye(K, dtype=torch.int32, device=kf.device))


def best_covisible(weights: torch.Tensor, kf: int, top_k: int):
    """Top-k covisible neighbours of keyframe ``kf``
    (GetBestCovisibilityKeyFrames); equal weights keep the lowest slot
    first, as ``lax.top_k`` does."""
    vals, idx = torch.sort(weights[kf], descending=True, stable=True)
    vals, idx = vals[:top_k], idx[:top_k]
    return torch.where(vals > 0, idx, -1).to(torch.int32), vals


def predict_scale(state_dist: torch.Tensor, max_dist: torch.Tensor,
                  scale_factor: float, n_levels: int) -> torch.Tensor:
    """Octave prediction from distance (MapPoint::PredictScale)."""
    ratio = max_dist / torch.clamp(state_dist, min=1e-9)
    # small epsilon so exact level boundaries (ratio == sf^k) don't round up
    level = torch.ceil(torch.log(ratio) / float(np.log(scale_factor)) - 1e-4)
    return torch.clamp(level.to(torch.int32), 0, n_levels - 1)


def n_observations(state: MapState) -> torch.Tensor:
    """(P,) int32 observation counts (MapPoint::Observations)."""
    ok = (state.pt_obs_kf >= 0) & state.kf_valid[
        torch.clamp(state.pt_obs_kf, min=0).long()
    ]
    return ok.sum(dim=1, dtype=torch.int32)
