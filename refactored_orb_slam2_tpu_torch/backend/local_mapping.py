"""Local mapping operations (port of backend/local_mapping.py): the work
sets, point fusion, recent-point culling, triangulation, keyframe
redundancy and removal that LocalMapping runs per keyframe.

- ``mapping_work_sets``   = the neighbour, window and candidate selections
  GetBestCovisibilityKeyFrames feeds (LocalMapping.cc:189/430/595);
- ``fuse_into_keyframe``  = ORBmatcher::Fuse + MapPoint::Replace
  (ORBmatcher.cc:766-907, MapPoint.cc:172-206);
- ``cull_recent_map_points`` = LocalMapping::MapPointCulling
  (LocalMapping.cc:155-183) over the recently created slots;
- ``triangulate_with_neighbor`` = CreateNewMapPoints + SearchForTriangulation
  (LocalMapping.cc:185-423, ORBmatcher.cc:614-764);
- ``keyframe_redundancy`` / ``remove_keyframe`` = KeyFrameCulling and
  KeyFrame::SetBadFlag (LocalMapping.cc:595-655, KeyFrame.cc:416-505).

Both descriptor searches (the fuse and the triangulation search) end in the
masked best-2 CUDA kernel.  The JAX package's ``lax.scan``/``lax.cond`` over
target lists becomes a host loop over the slots the caller read back.  Every
top-k is a stable descending sort (equal weights keep the lowest slot first,
as ``lax.top_k`` does) and every ``jnp.nonzero(size=...)`` a stable sort of
the mask, and the DLT's null vector is the ``dlt_nullvec`` kernel on the
card, so nothing here reads the device.

A triangulated neighbour and a fuse call are each a generator
(``triangulate_neighbor_gen``, ``fuse_gen``, ``fuse_targets_gen``) that
yields the masked best-2's arguments once and is sent its (d1, i1, d2):
``run_eager`` runs one to its end with the kernel's wrapper, and the
loops take another runner (``run=``), which on the card replays the step
as CUDA graphs around that one eager call (``SlamSystem._mapping_run``).
A keyframe slot is a host int or a (1,) int32 device tensor, which is
read with ``index_select`` and written with ``index_put_``: a slot that
lives on the card never goes through the host, as a capture requires.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend.fused_graph import drive
from ..frontend.tracking_kernels import project_in_image
from ..geometry import se3
from ..models.map_ops import add_observations, add_rows, nonzero_fixed, set_rows
from ..models.map_state import (
    MapState, covisibility_matrix, n_observations, predict_scale,
)
from ..ops import cuda_hamming
from ..ops import matching as M
from ..ops.image import scale_table


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: equal values keep the lowest index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _level_table(scale_factor: float, n_levels: int, device) -> torch.Tensor:
    """scale_factor ** level as float32 (the JAX ``sf`` array)."""
    return scale_table(tuple(scale_factor ** i for i in range(n_levels)), device)


def _mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """(n,) bool, True at ``idx``; entries equal to n are dropped."""
    return set_rows(torch.zeros(n, dtype=torch.bool, device=idx.device),
                    idx.reshape(-1), True)


def _row(bank: torch.Tensor, slot) -> torch.Tensor:
    """Row ``slot`` (a host int, or a (1,) device slot) of ``bank``."""
    if isinstance(slot, torch.Tensor):
        return bank.index_select(0, slot)[0]
    return bank[slot]


def _set_row(bank: torch.Tensor, slot, val: torch.Tensor) -> None:
    """Write ``val`` into row ``slot`` of ``bank``, in place."""
    if isinstance(slot, torch.Tensor):
        bank.index_put_((slot,), val[None])
    else:
        bank[slot] = val


def _put_row(bank: torch.Tensor, row, val: torch.Tensor) -> torch.Tensor:
    out = bank.clone()
    _set_row(out, row, val)
    return out


def best2(desc_a, desc_b, mask):
    """The masked best-2 a step yields for: ``cuda_hamming.hamming_best2``
    as the module holds it at the call, so that a wrapper put there sees
    every call."""
    return cuda_hamming.hamming_best2(desc_a, desc_b, mask)


def run_eager(step, *args, **kwargs):
    """The generator ``step(*args, **kwargs)`` run to its end, ``best2`` at
    its yield; returns what it returns."""
    return drive(step(*args, **kwargs), best2)


def fuse_into_keyframe(
    state: MapState,
    kf_slot,
    cam,
    pt_mask: torch.Tensor | None = None,
    *,
    budget: int,
    scale_factor: float,
    n_levels: int,
    th: float = 3.0,
    max_dist: int = 50,     # TH_LOW (ORBmatcher.cc:849)
    cand_idx: torch.Tensor | None = None,
) -> MapState:
    """Project map points into keyframe ``kf_slot``; add observations for
    unmatched features and merge duplicate landmarks (the point with more
    observations wins).

    Candidates: the ``budget`` nearest in-frustum points of the whole bank
    (optionally restricted by ``pt_mask``), or the compact slot list
    ``cand_idx`` ((C,) point slots, -1 padded), which direction 1 of
    SearchInNeighbors passes as the current keyframe's own point row."""
    return run_eager(fuse_gen, state, kf_slot, cam, pt_mask, budget=budget,
                     scale_factor=scale_factor, n_levels=n_levels, th=th,
                     max_dist=max_dist, cand_idx=cand_idx)


def fuse_gen(state: MapState, kf_slot, cam, pt_mask=None, *, budget: int,
             scale_factor: float, n_levels: int, th: float = 3.0, max_dist: int = 50,
             cand_idx=None):
    """``fuse_into_keyframe`` as a generator (module notes)."""
    K, N, P, O = state.capacity
    dev = state.pt_pos.device
    Tcw = _row(state.kf_pose, kf_slot)
    if cand_idx is not None and pt_mask is not None:
        raise ValueError(
            "fuse_into_keyframe: pt_mask is only honoured in the full-bank "
            "path; fold the mask into cand_idx (or pass cand_idx=None)"
        )
    if cand_idx is None:
        observed_here = torch.any(state.pt_obs_kf == kf_slot, dim=1)
        if pt_mask is not None:
            observed_here = observed_here | ~pt_mask
        pos, pt_valid_c, normal_c = state.pt_pos, state.pt_valid, state.pt_normal
        min_d_c, max_d_c = state.pt_min_dist, state.pt_max_dist
    else:
        ci = torch.clamp(cand_idx, min=0).long()
        row_ok = cand_idx >= 0
        observed_here = torch.any(state.pt_obs_kf[ci] == kf_slot, dim=1) | ~row_ok
        pos = state.pt_pos[ci]
        pt_valid_c = state.pt_valid[ci] & row_ok
        normal_c = state.pt_normal[ci]
        min_d_c, max_d_c = state.pt_min_dist[ci], state.pt_max_dist[ci]
    u, v, z_ok, in_img = project_in_image(cam, se3.transform(Tcw, pos))
    center = se3.translation(se3.inv(Tcw))
    po = pos - center
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * min_d_c) & (dist <= 1.2 * max_d_c)
    view_cos = torch.sum(po * normal_c, dim=-1) / torch.clamp(dist, min=1e-9)
    ok = pt_valid_c & z_ok & in_img & dist_ok & (view_cos > 0.5) & ~observed_here
    if cand_idx is None:
        top_score, top_idx = _top_k(torch.where(ok, -dist, float("-inf")), budget)
        sel_ok = torch.isfinite(top_score)
        dist_sel, maxd_sel = dist[top_idx], state.pt_max_dist[top_idx]
        u_sel, v_sel = u[top_idx], v[top_idx]
    else:
        top_idx = ci                                        # (C,) point slots
        sel_ok = ok
        dist_sel, maxd_sel = dist, max_d_c
        u_sel, v_sel = u, v
    pred = predict_scale(dist_sel, maxd_sel, scale_factor, n_levels)
    uv_sel = torch.stack([u_sel, v_sel], dim=-1)

    # --- match against this keyframe's features (masked best-2 kernel) ----
    sf = _level_table(scale_factor, n_levels, dev)
    radius = th * sf[torch.clamp(pred, 0, n_levels - 1).long()]
    geo = M.window_mask(uv_sel, _row(state.kf_xy, kf_slot), radius)
    geo = geo & M.octave_band_mask(pred, _row(state.kf_octave, kf_slot), -1, 1)
    d1, i1, d2 = yield (state.pt_desc[torch.clamp(top_idx, min=0).long()],
                        _row(state.kf_desc, kf_slot),
                        M.best2_mask(sel_ok, _row(state.kf_feat_valid, kf_slot), geo))
    res = M.resolve_duplicates(M.best2_result(d1, i1, d2, sel_ok, max_dist=max_dist), N)

    # candidate point per feature (-1 none)
    cand_pt = set_rows(torch.full((N,), -1, dtype=torch.int32, device=dev),
                       torch.where(res.mask, res.idx, N),
                       torch.where(res.mask, top_idx, -1).to(torch.int32))

    existing_pt = _row(state.kf_point_idx, kf_slot)
    n_obs = n_observations(state)

    # case A: the feature has no point -> add an observation
    add_pt = torch.where((existing_pt < 0) & (cand_pt >= 0), cand_pt, -1)
    # case B: the feature has a different point -> merge
    merge_mask = (existing_pt >= 0) & (cand_pt >= 0) & (existing_pt != cand_pt)
    pe = torch.clamp(existing_pt, min=0).long()
    pcand = torch.clamp(cand_pt, min=0).long()
    cand_wins = n_obs[pcand] >= n_obs[pe]
    loser = torch.where(cand_wins, pe, pcand)
    winner = torch.where(cand_wins, pcand, pe)

    # rewrite every keyframe's reference to a loser through the loser's own
    # observation list (an (N, O) scatter, not a (K, N) rewrite)
    l_list = torch.where(merge_mask, loser, 0)
    w_list = torch.where(merge_mask, winner, 0).to(torch.int32)
    lref_kf = state.pt_obs_kf[l_list]                          # (N, O)
    lref_ft = state.pt_obs_feat[l_list]
    upd_ok = merge_mask[:, None] & (lref_kf >= 0)
    flat = torch.where(upd_ok, lref_kf.long() * N + lref_ft.long(), K * N)
    new_kf_point_idx = set_rows(
        state.kf_point_idx.reshape(-1), flat.reshape(-1),
        w_list[:, None].expand(N, O).reshape(-1),
    ).reshape(K, N)
    # the fused keyframe's own row is rewritten directly
    own_row = torch.where(merge_mask, w_list, _row(new_kf_point_idx, kf_slot))
    _set_row(new_kf_point_idx, kf_slot, own_row)

    pt_valid = state.pt_valid & ~_mark(P, torch.where(merge_mask, loser, P))

    # each winner pulls its loser's observation list into its free slots;
    # winners live in the candidate set, so the pack runs on its rows only
    loser_of = set_rows(torch.full((P,), -1, dtype=torch.int32, device=dev),
                        torch.where(merge_mask, winner, P),
                        torch.where(merge_mask, loser, -1).to(torch.int32))
    w_rows = torch.clamp(top_idx, min=0).long()
    loser_b = loser_of[w_rows]
    has_loser_b = (loser_b >= 0) & sel_ok
    l_idx_b = torch.clamp(loser_b, min=0).long()
    l_obs_kf = torch.where(has_loser_b[:, None], state.pt_obs_kf[l_idx_b], -1)
    l_obs_ft = torch.where(has_loser_b[:, None], state.pt_obs_feat[l_idx_b], -1)
    cat_kf = torch.cat([state.pt_obs_kf[w_rows], l_obs_kf], dim=1)   # (C, 2O)
    cat_ft = torch.cat([state.pt_obs_feat[w_rows], l_obs_ft], dim=1)
    order = torch.sort((cat_kf < 0).to(torch.uint8), dim=1, stable=True).indices
    cat_kf = torch.gather(cat_kf, 1, order)[:, :O]
    cat_ft = torch.gather(cat_ft, 1, order)[:, :O]
    scatter_rows = torch.where(has_loser_b, w_rows, P)
    pt_obs_kf = set_rows(state.pt_obs_kf, scatter_rows, cat_kf)
    pt_obs_feat = set_rows(state.pt_obs_feat, scatter_rows, cat_ft)
    pt_obs_kf = torch.where(pt_valid[:, None], pt_obs_kf, -1)
    pt_obs_feat = torch.where(pt_valid[:, None], pt_obs_feat, -1)

    s = state.replace(kf_point_idx=new_kf_point_idx, pt_valid=pt_valid,
                      pt_obs_kf=pt_obs_kf, pt_obs_feat=pt_obs_feat)
    s = add_observations(s, kf_slot, add_pt)
    kf_pt = torch.where(add_pt >= 0, add_pt, _row(s.kf_point_idx, kf_slot))
    return s.replace(kf_point_idx=_put_row(s.kf_point_idx, kf_slot, kf_pt))


def fuse_into_keyframes(state: MapState, kf_slots, cam, *,
                        budget: int, scale_factor: float, n_levels: int,
                        th: float = 3.0, max_dist: int = 50,
                        cand_idx: torch.Tensor | None = None,
                        run=run_eager) -> MapState:
    """Fuse one candidate set into each keyframe of the host list
    ``kf_slots`` in turn (SearchInNeighbors direction 1,
    LocalMapping.cc:439-466); -1 entries are padding and are skipped.
    ``run`` runs each target's ``fuse_gen``."""
    for slot in kf_slots:
        if slot >= 0:
            state = run(fuse_gen, state, int(slot), cam, budget=budget,
                        scale_factor=scale_factor, n_levels=n_levels, th=th,
                        max_dist=max_dist, cand_idx=cand_idx)
    return state


def fuse_targets_gen(state: MapState, kf_slot, targets: torch.Tensor, cam, *,
                     budget: int, scale_factor: float, n_levels: int):
    """SearchInNeighbors direction 2 (LocalMapping.cc:468-509) as a
    generator: the landmarks that any keyframe of ``targets`` ((T,) slots,
    -1 padded) observes, fused into keyframe ``kf_slot``."""
    obs = state.pt_obs_kf
    in_tgt = torch.any(obs[:, :, None] == targets[None, None, :], dim=-1)
    tgt_mask = state.pt_valid & torch.any(in_tgt & (obs >= 0), dim=1)
    return (yield from fuse_gen(state, kf_slot, cam, tgt_mask, budget=budget,
                                scale_factor=scale_factor, n_levels=n_levels))


def update_visibility(state: MapState, visible_pt: torch.Tensor,
                      found_pt: torch.Tensor) -> MapState:
    """IncreaseVisible / IncreaseFound counters (MapPoint.cc:214-227)."""
    P = state.pt_visible.shape[0]
    return state.replace(
        pt_visible=add_rows(state.pt_visible, torch.where(visible_pt >= 0, visible_pt, P), 1),
        pt_found=add_rows(state.pt_found, torch.where(found_pt >= 0, found_pt, P), 1),
    )


def mapping_work_sets(state: MapState, kf_slot: int, ref_kf: int, *, nn: int,
                      t_cap: int, n_neighbors: int, window_k: int = 20,
                      cull_cap: int = 32):
    """Every per-keyframe neighbour, window and candidate selection, on the
    device from one covisibility matrix.

    Returns (tri_neighbors, fuse_slots, n_fuse_targets, fuse_tgt_mask,
    window_mask, fixed_mask, cull_cands), as the JAX function:
    - tri_neighbors (n_neighbors,): top covisible neighbours with weight
      > 15 (-1 padded);
    - fuse_slots (t_cap,): the top ``nn`` neighbours with weight > 0 and
      each one's top-5 second ring, in slot order (-1 padded);
    - n_fuse_targets: their count before the t_cap clamp; fuse_tgt_mask
      (K,) the same set as a mask;
    - window_mask / fixed_mask (K,): local BA window = top ``window_k`` +
      self, never the origin keyframe;
    - cull_cands (cull_cap,): keyframes with weight >= 15 other than the
      origin, self and the reference keyframe (-1 padded)."""
    K = state.kf_pose.shape[0]
    covis = covisibility_matrix(state)
    ids = torch.arange(K, device=covis.device)
    kf_ok = state.kf_valid
    row = torch.where(kf_ok & (ids != kf_slot), covis[kf_slot], 0)

    tri_w, tri_idx = _top_k(row, n_neighbors)
    tri_neighbors = torch.where(tri_w > 15, tri_idx, -1).to(torch.int32)

    f_w, f_idx = _top_k(row, nn)
    first_ok = f_w > 0
    rows2 = torch.where(kf_ok[None, :], covis[f_idx], 0)
    s_w, s_idx = _top_k(rows2, 5)
    ok2 = (s_w > 0) & first_ok[:, None]
    mask = _mark(K, torch.cat([torch.where(first_ok, f_idx, K),
                               torch.where(ok2, s_idx, K).reshape(-1)]))
    mask = mask & kf_ok & (ids != kf_slot)
    n_fuse_targets = mask.sum(dtype=torch.int32)
    fuse_slots = nonzero_fixed(mask, t_cap, -1).to(torch.int32)

    w_w, w_idx = _top_k(row, window_k)
    window = _mark(K, torch.where(w_w > 0, w_idx, K))
    window = (window | (ids == kf_slot)) & (ids != 0) & kf_ok
    fixed = ~window & kf_ok

    cull_ok = ((covis[kf_slot] >= 15) & kf_ok & (ids != 0) & (ids != kf_slot)
               & (ids != ref_kf))
    cull_cands = nonzero_fixed(cull_ok, cull_cap, -1).to(torch.int32)
    return (tri_neighbors, fuse_slots, n_fuse_targets, mask, window, fixed,
            cull_cands)


def cull_recent_map_points(state: MapState, current_kf: int, n_pt: int, *,
                           recent_cap: int = 4096, recent_window: int = 2,
                           min_found_ratio: float = 0.25,
                           min_obs_stereo: int = 3) -> MapState:
    """MapPointCulling over the recent point slots: point slots are handed
    out in rising order, so the recent set is the ``recent_cap`` slots that
    end at ``n_pt`` (a host counter)."""
    K, N, P, O = state.capacity
    R = min(recent_cap, P)
    start = int(np.clip(n_pt - R, 0, P - R))
    sl = slice(start, start + R)
    r_valid = state.pt_valid[sl]
    r_obs_kf = state.pt_obs_kf[sl]
    r_obs_ft = state.pt_obs_feat[sl]

    n_obs = (r_obs_kf >= 0).sum(dim=1, dtype=torch.int32)
    ratio = state.pt_found[sl].to(torch.float32) / torch.clamp(
        state.pt_visible[sl].to(torch.float32), min=1.0)
    bad_ratio = (state.pt_visible[sl] >= 3) & (ratio < min_found_ratio)
    age = current_kf - state.pt_first_kf[sl]
    recent = (age >= recent_window) & (age <= recent_window + 1)
    cull = r_valid & (bad_ratio | (recent & (n_obs < min_obs_stereo)))

    def upd(bank, val):
        out = bank.clone()
        out[sl] = val
        return out

    # clear the keyframe-side back pointers through the culled slice's own
    # observation pairs
    flat = torch.where(cull[:, None] & (r_obs_kf >= 0),
                       torch.clamp(r_obs_kf, min=0).long() * N
                       + torch.clamp(r_obs_ft, min=0).long(), K * N)
    clear = _mark(K * N, flat).reshape(K, N)
    return state.replace(
        pt_valid=upd(state.pt_valid, r_valid & ~cull),
        kf_point_idx=torch.where(clear, -1, state.kf_point_idx),
        pt_obs_kf=upd(state.pt_obs_kf, torch.where(cull[:, None], -1, r_obs_kf)),
        pt_obs_feat=upd(state.pt_obs_feat, torch.where(cull[:, None], -1, r_obs_ft)),
    )


def triangulate_with_neighbor(state: MapState, kf_a, kf_b, cam,
                              pt_base, *, max_new: int, scale_factor: float,
                              n_levels: int,
                              min_baseline_ratio: float = 0.01):
    """New landmarks from the unmatched features of keyframes ``kf_a`` and
    ``kf_b``: epipolar-gated descriptor matching (masked best-2 kernel),
    rotation histogram, DLT, then the reference's gates (positive depth,
    parallax, reprojection chi2, scale consistency, baseline).  The best
    ``max_new`` by chi2 take slots from ``pt_base`` (a host int or a 0-dim
    device tensor) on.  Returns (state, n_created as a 0-dim tensor)."""
    return run_eager(triangulate_gen, state, kf_a, kf_b, cam, pt_base, max_new=max_new,
                     scale_factor=scale_factor, n_levels=n_levels,
                     min_baseline_ratio=min_baseline_ratio)


def triangulation_gates(matched, p3d, Ta, Tb, xa, xb_m, oct_a, oct_bm, cam, *,
                        scale_factor: float, n_levels: int, min_baseline_ratio: float):
    """The reference's gates on a pair's DLT points (LocalMapping.cc:326-402):
    ``matched`` rows whose point is finite, in front of both cameras, seen
    with parallax, reprojected within chi2 in both views, at consistent
    scales and with enough baseline.  Returns (good, chi2 sum)."""
    sf = _level_table(scale_factor, n_levels, p3d.device)
    sigma2 = sf * sf
    Ca = se3.translation(se3.inv(Ta))
    Cb = se3.translation(se3.inv(Tb))
    baseline = torch.linalg.norm(Cb - Ca)
    pca, pcb = se3.transform(Ta, p3d), se3.transform(Tb, p3d)
    za, zb = pca[:, 2], pcb[:, 2]
    pos = (za > 1e-3) & (zb > 1e-3)
    finite = torch.all(torch.isfinite(p3d), dim=1)
    ra, rb = p3d - Ca, p3d - Cb
    cosp = torch.sum(ra * rb, dim=1) / (
        torch.linalg.norm(ra, dim=1) * torch.linalg.norm(rb, dim=1) + 1e-12)
    parallax_ok = cosp < 0.9998
    za_s = torch.where(pos, za, 1.0)
    zb_s = torch.where(pos, zb, 1.0)
    ea = (pca[:, :2] / za_s[:, None] - xa) * cam.fx
    eb = (pcb[:, :2] / zb_s[:, None] - xb_m) * cam.fx
    chi_a = torch.sum(ea * ea, dim=1) / sigma2[oct_a]
    chi_b = torch.sum(eb * eb, dim=1) / sigma2[oct_bm]
    reproj_ok = (chi_a <= 5.991) & (chi_b <= 5.991)
    # scale consistency (LocalMapping.cc:383-402)
    da = torch.linalg.norm(ra, dim=1)
    db = torch.linalg.norm(rb, dim=1)
    ratio_dist = da / torch.clamp(db, min=1e-9)
    ratio_oct = sf[oct_a] / sf[oct_bm]
    scale_ok = ((ratio_dist < ratio_oct * 1.5 * scale_factor)
                & (ratio_dist * 1.5 * scale_factor > ratio_oct))
    depth_scale = torch.minimum(za, zb)
    baseline_ok = baseline > min_baseline_ratio * torch.clamp(depth_scale, min=1e-6)
    good = matched & pos & finite & parallax_ok & reproj_ok & scale_ok & baseline_ok
    return good, chi_a + chi_b


def triangulate_gen(state: MapState, kf_a, kf_b, cam, pt_base, *, max_new: int,
                    scale_factor: float, n_levels: int, min_baseline_ratio: float = 0.01):
    """``triangulate_with_neighbor`` as a generator (module notes)."""
    K, N, P, O = state.capacity
    dev = state.pt_pos.device
    Ta, Tb = _row(state.kf_pose, kf_a), _row(state.kf_pose, kf_b)
    sf = _level_table(scale_factor, n_levels, dev)
    sigma2 = sf * sf

    Tba = Tb @ se3.inv(Ta)
    E = se3.hat(Tba[:3, 3]) @ Tba[:3, :3]

    def norm_coords(kf):
        xy = _row(state.kf_xy, kf)
        return torch.stack([(xy[:, 0] - cam.cx) / cam.fx,
                            (xy[:, 1] - cam.cy) / cam.fy], dim=-1)

    xa, xb = norm_coords(kf_a), norm_coords(kf_b)
    kf_point_a, kf_point_b = _row(state.kf_point_idx, kf_a), _row(state.kf_point_idx, kf_b)
    free_a = _row(state.kf_feat_valid, kf_a) & (kf_point_a < 0)
    free_b = _row(state.kf_feat_valid, kf_b) & (kf_point_b < 0)

    # epipolar distance of xb from the line E xa, in pixels via fx
    ones = torch.ones((N, 1), dtype=torch.float32, device=dev)
    lines = torch.cat([xa, ones], dim=1) @ E.T                 # (N, 3)
    num = torch.abs(lines @ torch.cat([xb, ones], dim=1).T)    # (Na, Nb)
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None] + 1e-12
    dist_px = num / den * cam.fx
    octave_a, octave_b = _row(state.kf_octave, kf_a), _row(state.kf_octave, kf_b)
    oct_b = torch.clamp(octave_b, 0, n_levels - 1).long()
    epi_ok = dist_px < 3.84 * torch.sqrt(sigma2[oct_b])[None, :]

    desc_a = _row(state.kf_desc, kf_a)
    d1, i1, d2 = yield (desc_a, _row(state.kf_desc, kf_b),
                        M.best2_mask(free_a, free_b, epi_ok))
    res = M.best2_result(d1, i1, d2, free_a, max_dist=50)   # TH_LOW
    keep = M.rotation_consistency_mask(_row(state.kf_angle, kf_a),
                                       _row(state.kf_angle, kf_b), res)
    res = M.MatchResult(idx=torch.where(keep, res.idx, -1),
                        dist=torch.where(keep, res.dist, M.BIG), mask=keep)
    res = M.resolve_duplicates(res, N)

    ib = torch.clamp(res.idx, min=0).long()
    xb_m = xb[ib]
    p3d = cuda_hamming.dlt_nullvec(Ta[:3], Tb[:3], xa, xb_m)
    oct_a = torch.clamp(octave_a, 0, n_levels - 1).long()
    good, chi = triangulation_gates(res.mask, p3d, Ta, Tb, xa, xb_m, oct_a, oct_b[ib], cam,
                                    scale_factor=scale_factor, n_levels=n_levels,
                                    min_baseline_ratio=min_baseline_ratio)

    # up to max_new, lowest chi2 sum first (stable, like jnp.argsort)
    order_key = torch.where(good, chi, float("inf"))
    chosen = torch.sort(order_key, stable=True).indices[:max_new]
    chosen_ok = good[chosen]
    n_new = chosen_ok.sum(dtype=torch.int32)
    # where the JAX scatter would drop a slot past the bank, so does this
    slot = pt_base + torch.cumsum(chosen_ok.to(torch.int32), 0) - 1
    slot = torch.clamp(torch.where(chosen_ok, slot, P), max=P).long()

    feat_a = chosen.to(torch.int32)
    feat_b = res.idx[chosen].to(torch.int32)
    pw = p3d[chosen]
    vec = pw - se3.translation(se3.inv(Ta))
    dist = torch.linalg.norm(vec, dim=1)
    normal = vec / torch.clamp(dist, min=1e-9)[:, None]
    octv = octave_a[chosen].to(torch.float32)
    max_dist = dist * torch.pow(scale_factor, octv)
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    obs_kf = set_rows(state.pt_obs_kf, slot, kf_a, col=0)
    obs_ft = set_rows(state.pt_obs_feat, slot, feat_a, col=0)
    s = state.replace(
        pt_pos=set_rows(state.pt_pos, slot, pw),
        pt_valid=set_rows(state.pt_valid, slot, chosen_ok),
        pt_desc=set_rows(state.pt_desc, slot, desc_a[chosen]),
        pt_normal=set_rows(state.pt_normal, slot, normal),
        pt_min_dist=set_rows(state.pt_min_dist, slot, min_dist),
        pt_max_dist=set_rows(state.pt_max_dist, slot, max_dist),
        pt_ref_kf=set_rows(state.pt_ref_kf, slot, kf_a),
        pt_first_kf=set_rows(state.pt_first_kf, slot, kf_a),
        pt_obs_kf=set_rows(obs_kf, slot, kf_b, col=1),
        pt_obs_feat=set_rows(obs_ft, slot, feat_b, col=1),
    )
    # keyframe-side back pointers; the rows not chosen write feature 0 of
    # kf_b back to itself, after the chosen rows (JAX's update order)
    slot32 = slot.to(torch.int32)
    row_a = set_rows(kf_point_a, feat_a,
                     torch.where(chosen_ok, slot32, kf_point_a[feat_a.long()]))
    kf_point_idx = _put_row(s.kf_point_idx, kf_a, row_a)
    row_b = _row(kf_point_idx, kf_b)
    feat_b_safe = torch.where(chosen_ok, feat_b, 0)
    row_b = set_rows(row_b, feat_b_safe,
                     torch.where(chosen_ok, slot32, row_b[feat_b_safe.long()]))
    return s.replace(kf_point_idx=_put_row(kf_point_idx, kf_b, row_b)), n_new


_TRI_BANKS = ("pt_pos", "pt_valid", "pt_desc", "pt_normal", "pt_min_dist",
              "pt_max_dist", "pt_ref_kf", "pt_first_kf", "pt_obs_kf",
              "pt_obs_feat", "kf_point_idx")


def triangulate_neighbor_gen(state: MapState, kf_a, kf_b, cam, base, *, max_new: int,
                             scale_factor: float, n_levels: int,
                             min_baseline_ratio: float = 0.01):
    """One neighbour of ``triangulate_with_neighbors`` as a generator
    (module notes): ``triangulate_gen`` from the 0-dim device count
    ``base`` on, kept only where the bank can still hold a ``max_new``
    batch from there.  Returns (state, the next base)."""
    P = state.pt_pos.shape[0]
    s2, n_new = yield from triangulate_gen(
        state, kf_a, kf_b, cam, base, max_new=max_new, scale_factor=scale_factor,
        n_levels=n_levels, min_baseline_ratio=min_baseline_ratio)
    ok = base + max_new <= P
    s2 = s2.replace(**{f: torch.where(ok, getattr(s2, f), getattr(state, f))
                       for f in _TRI_BANKS})
    return s2, base + torch.where(ok, n_new, 0)


def triangulate_with_neighbors(state: MapState, kf_a: int, neighbors, cam,
                               pt_base: int, *, max_new: int,
                               scale_factor: float, n_levels: int,
                               min_baseline_ratio: float = 0.01, run=run_eager):
    """CreateNewMapPoints over the host list ``neighbors`` (-1 padding is
    skipped), allocating from ``pt_base`` on, and stopping once the bank
    cannot hold another ``max_new`` batch.  That stop depends on the count
    created so far, which lives on the device, so every neighbour runs and
    its result is kept only where the device count passes.  ``run`` runs
    each neighbour's ``triangulate_neighbor_gen``.  Returns (state,
    n_created_total as a 0-dim tensor)."""
    base = torch.full((), pt_base, dtype=torch.int32, device=state.pt_pos.device)
    for nb in neighbors:
        if nb < 0:
            continue
        state, base = run(triangulate_neighbor_gen, state, kf_a, int(nb), cam, base,
                          max_new=max_new, scale_factor=scale_factor, n_levels=n_levels,
                          min_baseline_ratio=min_baseline_ratio)
    return state, base - pt_base


def keyframe_redundancy(state: MapState, kf_slots: torch.Tensor, *,
                        min_obs: int = 3) -> torch.Tensor:
    """(C,) fraction of each keyframe's landmarks that at least ``min_obs``
    other keyframes observe at the same or a finer octave
    (KeyFrameCulling, LocalMapping.cc:595-655), for the (C,) slots
    ``kf_slots``: the JAX function vmapped over its slot argument.  The
    caller culls a keyframe above 0.9."""
    kf = kf_slots.long()
    pt = state.kf_point_idx[kf]                               # (C, N)
    has = (pt >= 0) & state.kf_feat_valid[kf]
    ptc = torch.clamp(pt, min=0).long()
    obs_kf = state.pt_obs_kf[ptc]                             # (C, N, O)
    obs_ft = state.pt_obs_feat[ptc]
    okc = torch.clamp(obs_kf, min=0).long()
    obs_ok = (obs_kf >= 0) & (obs_kf != kf_slots[:, None, None]) & state.kf_valid[okc]
    oct_other = state.kf_octave[okc, torch.clamp(obs_ft, min=0).long()]
    scale_ok = oct_other <= state.kf_octave[kf][..., None] + 1
    n_good = (obs_ok & scale_ok).sum(dim=-1, dtype=torch.int32)
    redundant = has & (n_good >= min_obs)
    n_pts = torch.clamp(has.sum(dim=-1, dtype=torch.int32), min=1)
    return redundant.sum(dim=-1, dtype=torch.int32) / n_pts.to(torch.float32)


def remove_keyframe(state: MapState, kf_slot: int) -> MapState:
    """Invalidate a keyframe and drop its observations from every landmark
    (KeyFrame::SetBadFlag; re-parenting is the caller's host bookkeeping)."""
    drop = state.pt_obs_kf == kf_slot
    # fill_, not item assignment, which copies a Python scalar from the host
    kf_valid = state.kf_valid.clone()
    kf_valid[kf_slot].fill_(False)
    kf_point_idx = state.kf_point_idx.clone()
    kf_point_idx[kf_slot].fill_(-1)
    return state.replace(
        kf_valid=kf_valid,
        pt_obs_kf=torch.where(drop, -1, state.pt_obs_kf),
        pt_obs_feat=torch.where(drop, -1, state.pt_obs_feat),
        kf_point_idx=kf_point_idx,
    )
