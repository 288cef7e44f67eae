"""Functional map mutations on the RGB-D slice: keyframe insertion and
close-point creation from depth (port of models/map_ops.py).

JAX writes with ``.at[idx].set(..., mode="drop")`` and parks rejected rows
at index P; here those rows land in one extra dump row that is sliced off
(``set_rows``, ``add_rows``), because torch raises on an out-of-range index.
"""

from __future__ import annotations

import torch

from ..geometry import se3
from .map_state import MapState


def _on_device(val, bank: torch.Tensor) -> torch.Tensor:
    """``val`` as a tensor on ``bank``'s device.  Assigning a Python scalar
    into a CUDA tensor copies it from host memory and synchronizes;
    ``torch.full`` fills on the device."""
    if isinstance(val, torch.Tensor):
        return val
    return torch.full((), val, dtype=bank.dtype, device=bank.device)


def set_rows(bank: torch.Tensor, idx: torch.Tensor, val, col=None) -> torch.Tensor:
    """Copy of ``bank`` with rows ``idx`` (or cells ``(idx, col)``) set to
    ``val``; entries with ``idx == len(bank)`` are dropped."""
    out = torch.cat([bank, bank[:1]], dim=0)
    if col is None:
        out[idx.long()] = _on_device(val, bank)
    else:
        out[idx.long(), col] = _on_device(val, bank)
    return out[:-1]


def add_rows(bank: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Copy of ``bank`` with ``val`` added at rows ``idx`` (repeats add up);
    entries with ``idx == len(bank)`` are dropped."""
    out = torch.cat([bank, bank[:1]], dim=0)
    out.index_put_((idx.long(),), _on_device(val, bank), accumulate=True)
    return out[:-1]


def insert_keyframe(
    state: MapState,
    kf_slot: int,
    frame_id: int,
    Tcw: torch.Tensor,
    frame_xy: torch.Tensor,
    frame_uvr: torch.Tensor,
    frame_octave: torch.Tensor,
    frame_angle: torch.Tensor,
    frame_desc: torch.Tensor,
    frame_valid: torch.Tensor,
    matched_pt: torch.Tensor,   # (N,) point slot tracked by each feature (-1)
    parent_kf: int,             # spanning-tree parent (-1 for the first KF)
) -> MapState:
    """Snapshot a frame into keyframe slot ``kf_slot`` and register its
    tracked matches as observations on the map points."""
    matched = torch.where(frame_valid, matched_pt, -1).to(torch.int32)

    def put(bank, val):
        out = bank.clone()
        out[kf_slot] = _on_device(val, bank)
        return out

    s = state.replace(
        kf_pose=put(state.kf_pose, Tcw),
        kf_valid=put(state.kf_valid, True),
        kf_frame_id=put(state.kf_frame_id, frame_id),
        kf_xy=put(state.kf_xy, frame_xy),
        kf_uvr=put(state.kf_uvr, frame_uvr),
        kf_octave=put(state.kf_octave, frame_octave),
        kf_angle=put(state.kf_angle, frame_angle),
        kf_desc=put(state.kf_desc, frame_desc),
        kf_feat_valid=put(state.kf_feat_valid, frame_valid),
        kf_point_idx=put(state.kf_point_idx, matched),
        kf_parent=put(state.kf_parent, parent_kf),
    )
    return add_observations(s, kf_slot, matched)


def add_observations(state: MapState, kf_slot: int,
                     matched_pt: torch.Tensor) -> MapState:
    """Append (kf_slot, feature) observations for every feature with a
    point; each point gains at most one observation."""
    K, N, P, O = state.capacity
    dev = matched_pt.device
    feat_ids = torch.arange(N, dtype=torch.int32, device=dev)
    scatter_idx = torch.where(matched_pt >= 0, matched_pt, P)
    feat_of_pt = set_rows(torch.full((P,), -1, dtype=torch.int32, device=dev),
                           scatter_idx, feat_ids)
    already = torch.any(state.pt_obs_kf == kf_slot, dim=1)
    free = state.pt_obs_kf < 0
    new_obs = (feat_of_pt >= 0) & state.pt_valid & ~already & torch.any(free, dim=1)
    free_slot = torch.argmax(free.to(torch.int32), dim=1)      # first free slot
    col_hit = (torch.arange(O, device=dev)[None, :] == free_slot[:, None]) \
        & new_obs[:, None]
    return state.replace(
        pt_obs_kf=torch.where(col_hit, kf_slot, state.pt_obs_kf),
        pt_obs_feat=torch.where(col_hit, feat_of_pt[:, None], state.pt_obs_feat),
    )


def create_points_from_depth(
    state: MapState,
    kf_slot: int,
    depth: torch.Tensor,       # (N,) per-feature depth (-1 invalid)
    matched_pt: torch.Tensor,  # (N,) existing point per feature (-1)
    cam,
    th_depth: float,
    pt_base: int,              # first free point slot (host counter)
    max_new: int,
) -> tuple[MapState, torch.Tensor]:
    """Create up to ``max_new`` close RGB-D points for unmatched features,
    nearest first (Tracking.cc:454-503, 976-1023).

    Returns (new state, number created as a 0-dim tensor).  New points take
    slots [pt_base, pt_base + n_new).
    """
    K, N, P, O = state.capacity
    feat_valid = state.kf_feat_valid[kf_slot]
    eligible = feat_valid & (depth > 0) & (depth < th_depth) & (matched_pt < 0)
    # nearest first; a stable sort keeps ties in feature order like jnp.argsort
    order = torch.sort(torch.where(eligible, depth, float("inf")), stable=True).indices
    chosen_feat = order[:max_new]
    chosen_ok = eligible[chosen_feat]
    n_new = chosen_ok.sum(dtype=torch.int32)

    Twc = se3.inv(state.kf_pose[kf_slot])
    d = depth[chosen_feat]
    uv = state.kf_xy[kf_slot][chosen_feat]
    x = (uv[:, 0] - cam.cx) / cam.fx * d
    y = (uv[:, 1] - cam.cy) / cam.fy * d
    pw = se3.transform(Twc, torch.stack([x, y, d], dim=-1))

    slot = pt_base + torch.cumsum(chosen_ok.to(torch.int32), 0) - 1
    slot = torch.where(chosen_ok, slot, P)

    desc = state.kf_desc[kf_slot][chosen_feat]
    vec = pw - se3.translation(Twc)
    dist = torch.linalg.norm(vec, dim=-1)
    normal = vec / torch.clamp(dist, min=1e-9)[:, None]
    octv = state.kf_octave[kf_slot][chosen_feat].to(torch.float32)
    # distance band seeded from the creating observation with the default
    # scale factor; update_point_stats refines it
    sf = 1.2
    max_dist = dist * torch.pow(sf, octv)
    min_dist = max_dist / (sf ** 7)

    s = state.replace(
        pt_pos=set_rows(state.pt_pos, slot, pw),
        pt_valid=set_rows(state.pt_valid, slot, chosen_ok),
        pt_desc=set_rows(state.pt_desc, slot, desc),
        pt_normal=set_rows(state.pt_normal, slot, normal),
        pt_min_dist=set_rows(state.pt_min_dist, slot, min_dist),
        pt_max_dist=set_rows(state.pt_max_dist, slot, max_dist),
        pt_ref_kf=set_rows(state.pt_ref_kf, slot, kf_slot),
        pt_first_kf=set_rows(state.pt_first_kf, slot, kf_slot),
        pt_obs_kf=set_rows(state.pt_obs_kf, slot, kf_slot, col=0),
        pt_obs_feat=set_rows(state.pt_obs_feat, slot, chosen_feat.to(torch.int32),
                              col=0),
    )
    # register on the keyframe's feature bank too (rejected rows keep their
    # existing value — they may hold legitimate matches)
    kf_pt = s.kf_point_idx[kf_slot].clone()
    kf_pt[chosen_feat] = torch.where(chosen_ok, slot.to(torch.int32),
                                     kf_pt[chosen_feat])
    kf_point_idx = s.kf_point_idx.clone()
    kf_point_idx[kf_slot] = kf_pt
    return s.replace(kf_point_idx=kf_point_idx), n_new
