"""Functional map mutations (port of models/map_ops.py): keyframe
insertion, close-point creation from depth, the local-BA window's gather
into a compact problem and scatter back, and the whole-map BA problem of
global BA with its writeback.

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


def _last_wins(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every repeated index but its last occurrence moved to
    the dump row ``n``.  JAX on the CPU applies a scatter's updates in
    order, so the last one of a repeated index stays; an index assignment
    with repeats is unordered in PyTorch (threads on the CPU, atomics on
    the card)."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, rows, "amax")
    return torch.where(last[idx] == rows, idx, n)


def set_rows(bank: torch.Tensor, idx: torch.Tensor, val, col=None) -> torch.Tensor:
    """Copy of ``bank`` with rows ``idx`` (or cells ``(idx, col)``) set to
    ``val``; entries with ``idx == len(bank)`` are dropped, and of repeated
    indices the last entry wins, as in JAX's ``.at[idx].set``."""
    out = torch.cat([bank, bank[:1]], dim=0)
    idx = _last_wins(idx.long().reshape(-1), bank.shape[0]).reshape(idx.shape)
    if col is None:
        out[idx] = _on_device(val, bank)
    else:
        out[idx, col] = _on_device(val, bank)
    return out[:-1]


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a 1-D mask,
    with no host read: the True slots in rising order (a stable sort of the
    mask), padded with ``fill``."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    n = mask.shape[0]
    if size > n:
        order = torch.cat([order, order.new_zeros(size - n)])
    order = order[:size]
    ok = mask[order] & (torch.arange(size, device=mask.device) < n)
    return torch.where(ok, order, fill)


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


def gather_ba_window(state: MapState, window_mask_kf: torch.Tensor,
                     fixed_mask_kf: torch.Tensor, inv_sigma2_table: torch.Tensor,
                     *, max_kfs: int, max_points: int, max_obs: int):
    """The local-BA subgraph (Optimizer.cc:437-533) gathered into a small
    static-shape ``BAProblem``: the window keyframes, every point one of
    them observes, and, fixed, the other keyframes observing those points,
    most observations first when they overflow ``max_kfs``.  Where
    ``max_obs`` is below the bank's O, each point keeps its ``max_obs``
    highest-priority observation slots (window keyframes first); otherwise
    all O, in slot order.

    Returns (problem, kf_sel, pt_sel, obs_sel, n_pt_in): compact rows back
    to map slots (pad rows point one past the end), compact obs columns
    back to obs slots, and the window's point count before the
    ``max_points`` clamp."""
    from ..optim.bundle_adjustment import BAProblem

    K, N, P, O = state.capacity
    dev = state.pt_pos.device
    max_kfs, max_points = min(max_kfs, K), min(max_points, P)
    window = window_mask_kf & state.kf_valid
    # obs slots of removed keyframes are cleared, so >= 0 is liveness
    obs_exists = state.pt_obs_kf >= 0

    win_slots = nonzero_fixed(window, max_kfs, K)
    obs_in_window = torch.any(state.pt_obs_kf[:, :, None] == win_slots[None, None, :],
                              dim=-1)
    pt_in = state.pt_valid & torch.any(obs_exists & obs_in_window, dim=1)
    n_pt_in = pt_in.sum(dtype=torch.int32)
    pt_sel = nonzero_fixed(pt_in, max_points, P)
    pt_ok = pt_sel < P
    psafe = torch.clamp(pt_sel, 0, P - 1)

    # keyframes observing the selected points, ranked by observation count
    # (lFixedCameras, Optimizer.cc:517-532); integer adds are exact in any
    # order
    sel_obs_kf = state.pt_obs_kf[psafe]                        # (Pw, O)
    sel_obs_ok = obs_exists[psafe] & pt_ok[:, None]
    obs_ct = torch.zeros(K, dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp(sel_obs_kf, min=0).reshape(-1).long(),
        sel_obs_ok.reshape(-1).long())
    fixed_eff = fixed_mask_kf & state.kf_valid & ~window & (obs_ct > 0)
    rank = torch.where(window, 0, torch.where(fixed_eff, 1, 2))
    # window first, then fixed by observation count, then slot (lexsort)
    ids = torch.arange(K, device=dev)
    key = (rank * (P * O + 1) + (P * O - obs_ct)) * K + ids
    kf_sel = torch.sort(key).indices[:max_kfs]
    kf_in = rank[kf_sel] < 2
    kf_sel = torch.where(kf_in, kf_sel, K)
    ksafe = torch.clamp(kf_sel, 0, K - 1)
    # map slot -> compact row (entry K absorbs the pads)
    kf_map = set_rows(torch.full((K + 1,), -1, dtype=torch.int32, device=dev),
                      kf_sel, torch.arange(max_kfs, dtype=torch.int32, device=dev))

    compact_kf = kf_map[torch.clamp(sel_obs_kf, 0, K).long()]  # (Pw, O)
    obs_ok = sel_obs_ok & (compact_kf >= 0)
    sel_obs_feat = torch.clamp(state.pt_obs_feat[psafe], min=0)
    if max_obs < O:
        in_window = window[torch.clamp(sel_obs_kf, min=0).long()] & obs_ok
        prio = torch.where(in_window, 0, torch.where(obs_ok, 1, 2))
        obs_sel = torch.sort(prio, dim=1, stable=True).indices[:, :max_obs]
        sel_obs_kf, sel_obs_feat, compact_kf, obs_ok = (
            torch.gather(x, 1, obs_sel)
            for x in (sel_obs_kf, sel_obs_feat, compact_kf, obs_ok))
    else:
        obs_sel = torch.arange(O, device=dev)[None, :].expand(obs_ok.shape)

    kfo = torch.clamp(sel_obs_kf, min=0).long()
    uvr = state.kf_uvr[kfo, sel_obs_feat.long()]
    octv = state.kf_octave[kfo, sel_obs_feat.long()]
    inv_s2 = inv_sigma2_table[torch.clamp(octv, 0, inv_sigma2_table.shape[0] - 1).long()]
    prob = BAProblem(
        kf_poses=state.kf_pose[ksafe],
        kf_fixed=kf_in & ~window[ksafe],
        kf_valid=kf_in,
        points=state.pt_pos[psafe],
        point_valid=pt_ok,
        obs_kf=torch.where(obs_ok, compact_kf, -1),
        obs_uvr=uvr,
        obs_inv_sigma2=inv_s2,
        obs_is_stereo=uvr[..., 2] >= 0,
        obs_valid=obs_ok,
    )
    return prob, kf_sel, pt_sel, obs_sel, n_pt_in


def scatter_ba_window(state: MapState, prob, kf_sel, pt_sel, obs_sel,
                      ba_poses, ba_points, ba_obs_valid) -> MapState:
    """Write compact-window BA results back into the map (Optimizer.cc:
    696-744): poses of the optimized keyframes, point positions, and the
    outlier observations erased on both sides of the incidence."""
    K, N, P, O = state.capacity
    opt_kf = prob.kf_valid & ~prob.kf_fixed
    kf_pose = set_rows(state.kf_pose, torch.where(opt_kf, kf_sel, K), ba_poses)
    pt_tgt = torch.where(prob.point_valid, pt_sel, P)
    pt_pos = set_rows(state.pt_pos, pt_tgt, ba_points)

    # the compact (Pw, O') dropped mask back on the original (Pw, O) slots
    dropped_c = prob.obs_valid & ~ba_obs_valid
    dropped = torch.zeros(dropped_c.shape[0], O, dtype=torch.bool,
                          device=dropped_c.device).scatter_(1, obs_sel, dropped_c)
    psafe = torch.clamp(pt_sel, 0, P - 1)
    row_kf = state.pt_obs_kf[psafe]
    row_ft = state.pt_obs_feat[psafe]
    flat = torch.where(dropped & (pt_sel < P)[:, None],
                       torch.clamp(row_kf, min=0).long() * N
                       + torch.clamp(row_ft, min=0).long(), K * N)
    clear = set_rows(torch.zeros(K * N, dtype=torch.bool, device=flat.device),
                     flat.reshape(-1), True).reshape(K, N)
    return state.replace(
        kf_pose=kf_pose,
        pt_pos=pt_pos,
        pt_obs_kf=set_rows(state.pt_obs_kf, pt_tgt, torch.where(dropped, -1, row_kf)),
        pt_obs_feat=set_rows(state.pt_obs_feat, pt_tgt, torch.where(dropped, -1, row_ft)),
        kf_point_idx=torch.where(clear, -1, state.kf_point_idx),
    )


def build_ba_problem(state: MapState, window_mask_kf: torch.Tensor,
                     fixed_mask_kf: torch.Tensor, inv_sigma2_table: torch.Tensor):
    """A ``BAProblem`` over the whole bank for the given keyframe window:
    every valid point observed by a window keyframe (Optimizer.cc:471-485),
    with its observations by keyframes outside the window and the fixed set
    dropped (those keyframes are no vertices)."""
    from ..optim.bundle_adjustment import BAProblem

    in_problem = window_mask_kf | fixed_mask_kf
    kfc = torch.clamp(state.pt_obs_kf, min=0).long()
    ftc = torch.clamp(state.pt_obs_feat, min=0).long()
    obs_ok = (state.pt_obs_kf >= 0) & state.kf_valid[kfc] & in_problem[kfc]
    pt_in = state.pt_valid & torch.any(obs_ok & window_mask_kf[kfc], dim=1)
    obs_ok = obs_ok & pt_in[:, None]
    uvr = state.kf_uvr[kfc, ftc]                                # (P, O, 3)
    octv = state.kf_octave[kfc, ftc]
    inv_s2 = inv_sigma2_table[torch.clamp(octv, 0, inv_sigma2_table.shape[0] - 1).long()]
    return BAProblem(
        kf_poses=state.kf_pose,
        kf_fixed=fixed_mask_kf | ~window_mask_kf,
        kf_valid=state.kf_valid & in_problem,
        points=state.pt_pos,
        point_valid=pt_in,
        obs_kf=torch.where(obs_ok, state.pt_obs_kf, -1),
        obs_uvr=uvr,
        obs_inv_sigma2=inv_s2,
        obs_is_stereo=uvr[..., 2] >= 0,
        obs_valid=obs_ok,
    )


def writeback_ba(state: MapState, ba_poses: torch.Tensor, ba_points: torch.Tensor,
                 ba_obs_valid: torch.Tensor, prob) -> MapState:
    """Apply a whole-map BA result: poses of the optimized keyframes,
    positions of the points in the problem, and the observations the BA
    classified as outliers erased on both sides (Optimizer.cc:696-744)."""
    K, N, P, O = state.capacity
    opt_kf = prob.kf_valid & ~prob.kf_fixed
    dropped = prob.obs_valid & ~ba_obs_valid
    flat = torch.where(dropped, torch.clamp(state.pt_obs_kf, min=0).long() * N
                       + torch.clamp(state.pt_obs_feat, min=0).long(), K * N)
    clear = set_rows(torch.zeros(K * N, dtype=torch.bool, device=flat.device),
                     flat.reshape(-1), True).reshape(K, N)
    return state.replace(
        kf_pose=torch.where(opt_kf[:, None, None], ba_poses, state.kf_pose),
        pt_pos=torch.where(prob.point_valid[:, None], ba_points, state.pt_pos),
        pt_obs_kf=torch.where(dropped, -1, state.pt_obs_kf),
        pt_obs_feat=torch.where(dropped, -1, state.pt_obs_feat),
        kf_point_idx=torch.where(clear, -1, state.kf_point_idx),
    )
