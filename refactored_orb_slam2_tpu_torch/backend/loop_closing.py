"""Loop closing: detection, Sim3 alignment, the projection count, and the
essential graph's edges (port of backend/loop_closing.py; the LoopClosing
thread, LoopClosing.cc).

- ``detect`` = DetectLoop (LoopClosing.cc:94-215): the keyframe-gap gate,
  BoW candidates from the KeyFrameDB (``place.keyframe_db``) and the
  covisibility-consistency chaining over 3 consecutive keyframes, on the
  host over one read of the candidates and their covisibility rows;
- ``detect_orbslam2``: the reference's DetectLoop itself, which the async
  mode runs instead (its database, word test and consistency rule);
- ``compute_sim3`` = ComputeSim3 (LoopClosing.cc:217-373): a mutual
  descriptor match between the current and the candidate keyframe's
  landmark features, Horn Sim3 RANSAC (scale free for monocular), the
  masked Horn refit, SearchBySim3 growth and the joint refinement, as
  device work with two reads at the end;
- ``count_loop_projection_matches``: the loop neighbourhood's landmarks
  through the corrected Sim3 into the current keyframe, a windowed
  non-mutual match (``ops.matching.nn_match_desc``, the masked best-2 CUDA
  kernel on the card), the reference's >= 40 acceptance evidence;
- ``build_essential_graph_edges`` = the essential graph's topology
  (Optimizer.cc:796-1000).

The correction itself (propagation, SearchAndFuse, the pose graph, the
point correction) and the global BA run in ``system.SlamSystem``.  The
RANSAC's minimal sets come from a CPU ``torch.Generator`` (the system seeds
it with the frame id, as the JAX package seeds ``PRNGKey(frame_id)``), or
from ``sets=``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..geometry import se3, sim3
from ..models.map_ops import set_rows
from ..models.map_state import predict_scale
from ..ops import matching as M
from ..ops.descriptors import hamming
from ..optim import pose_graph as PG
from ..place.keyframe_db import detect_loop_candidates
from ..place.vocab import bow_score
from ..solvers.horn_sim3 import horn_sim3_masked, sim3_ransac


@dataclasses.dataclass
class LoopState:
    """Host-side loop-closing bookkeeping (consistency chains, last loop)."""

    consistent_groups: list = dataclasses.field(default_factory=list)
    last_loop_kf: int = -1


def detect(loop_state: LoopState, db, kf_slot: int, query_bow: torch.Tensor,
           covis: torch.Tensor, *, kf_gap: int = 10, consistency_th: int = 3,
           covis_neighbor_th: int = 15) -> list[int]:
    """Loop detection with covisibility-consistency chaining.  ``covis`` is
    the (K, K) weight matrix on the device; the candidates and their rows
    come back in one read (8 x 513 int32 at K = 512).  Returns the keyframe
    slots detected consistently over ``consistency_th`` consecutive
    keyframes (usually none)."""
    if loop_state.last_loop_kf >= 0 and kf_slot - loop_state.last_loop_kf < kf_gap:
        return []
    if kf_slot < kf_gap:
        return []
    cands, _ = detect_loop_candidates(db, query_bow, kf_slot, covis)
    rows = covis.index_select(0, torch.clamp(cands, min=0).long())
    host = torch.cat([cands[:, None], rows], dim=1).cpu().numpy()
    row_of = {int(r[0]): r[1:] for r in host if r[0] >= 0}
    if not row_of:
        loop_state.consistent_groups = []
        return []

    enough: list[int] = []
    new_groups = []
    for c, row in row_of.items():
        group = {c} | {int(i) for i in np.where(row >= covis_neighbor_th)[0]}
        count = 0
        for prev_group, prev_count in loop_state.consistent_groups:
            if group & prev_group:
                count = max(count, prev_count + 1)
        new_groups.append((group, count))
        if count + 1 >= consistency_th:
            enough.append(c)
    loop_state.consistent_groups = new_groups
    return enough


def _ordered_connected(row: np.ndarray, th: int = 15) -> list[int]:
    """KeyFrame::GetVectorCovisibleKeyFrames from a covisibility row: the
    keyframes sharing >= ``th`` points, heaviest first, or the heaviest
    alone when none reaches ``th`` (KeyFrame::UpdateConnections)."""
    idx = np.nonzero(row >= th)[0]
    if len(idx) == 0:
        j = int(np.argmax(row))
        return [j] if row[j] > 0 else []
    return idx[np.argsort(-row[idx], kind="stable")].tolist()


def detect_orbslam2(loop_state: LoopState, db, kf_slot: int, covis: torch.Tensor,
                    n_kf: int, *, kf_gap: int = 10, consistency_th: int = 3,
                    record: Optional[dict] = None) -> list[int]:
    """The reference's own DetectLoop (LoopClosing.cc:94-215) over
    KeyFrameDatabase::DetectLoopCandidates (KeyFrameDatabase.cc:72-193),
    which the async mode runs in place of ``detect`` (ROADMAP, faults in
    the reference):

    - the database holds the keyframes the loop closer has processed, those
      before ``kf_slot`` (the reference adds a keyframe after its own
      DetectLoop), less the culled ones;
    - minScore is the lowest score against the query's ordered connected
      keyframes (>= 15 shared points, or the heaviest), from 1;
    - a database keyframe is scored if it shares a word with the query, is
      not covisible with it, and shares more than 0.8 x the most shared
      words; kept if its score >= minScore;
    - each kept one accumulates the scores of its 10 best covisible
      keyframes that passed the word test, and the group's best member is
      returned when the sum is above 0.75 x the best sum (from minScore);
    - a candidate's group is itself and every keyframe covisible with it;
      it counts one more than a previous group it shares a keyframe with,
      each previous group carried once, and is consistent at a count of
      ``consistency_th`` (four detections in a row at 3).

    One read of the scores, the shared word counts, the database's slots
    and the covisibility among the first ``n_kf`` keyframes, the rest on
    the host.  ``record``, when given, receives the step (the database's
    slots, the connected keyframes, minScore, the scored slots, the
    candidates, the groups, the consistent candidates)."""
    if kf_slot < max(loop_state.last_loop_kf, 0) + kf_gap:
        return []
    n = max(n_kf, kf_slot + 1)
    slots = torch.arange(n, device=covis.device)
    q = db.bow[kf_slot]
    bank = db.bow[:n]
    rows = torch.cat([covis[:n, :n].to(torch.float32),
                      torch.stack([bow_score(q, bank),
                                   ((bank > 0) & (q > 0)).sum(dim=1).to(torch.float32),
                                   (db.valid[:n] & (slots < kf_slot)).to(torch.float32)])])
    host = rows.cpu().numpy()
    cv, score, shared, in_db = host[:n], host[n], host[n + 1], host[n + 2] > 0

    connected = _ordered_connected(cv[kf_slot])
    min_score = min([1.0] + [float(score[c]) for c in connected])
    sharing = in_db & (cv[kf_slot] <= 0) & (shared > 0)
    passed = sharing & (shared > int(0.8 * shared[sharing].max())) if sharing.any() else sharing
    scored = np.nonzero(passed & (score >= min_score))[0].tolist()
    best_acc, accs = min_score, []
    for j in scored:
        acc, best, best_s = float(score[j]), j, float(score[j])
        for nb in _ordered_connected(cv[j])[:10]:
            if passed[nb]:
                acc += float(score[nb])
                if score[nb] > best_s:
                    best, best_s = nb, float(score[nb])
        accs.append((acc, best))
        best_acc = max(best_acc, acc)
    cands: list[int] = []
    for acc, best in accs:
        if acc > 0.75 * best_acc and best not in cands:
            cands.append(best)

    groups, carried, enough = [], [False] * len(loop_state.consistent_groups), []
    for c in cands:
        group = {c} | {int(i) for i in np.nonzero(cv[c] > 0)[0]}
        matched = found = False
        for i, (prev, count) in enumerate(loop_state.consistent_groups):
            if not group & prev:
                continue
            matched = True
            if not carried[i]:
                groups.append((group, count + 1))
                carried[i] = True
            if count + 1 >= consistency_th and not found:
                enough.append(c)
                found = True
        if not matched:
            groups.append((group, 0))
    loop_state.consistent_groups = groups
    if record is not None:
        record.update(kf=kf_slot, valid=np.nonzero(in_db)[0].tolist(), connected=connected,
                      min_score=min_score, scored=scored, candidates=cands,
                      groups=[[sorted(g), c] for g, c in groups], consistent=enough)
    return enough


def _normalized(cam, xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([(xy[:, 0] - cam.cx) / cam.fx, (xy[:, 1] - cam.cy) / cam.fy], dim=1)


def compute_sim3(state, cam, kf_cur: int, kf_cand: int, *, fix_scale: bool,
                 generator: Optional[torch.Generator] = None,
                 sets: Optional[torch.Tensor] = None, min_inliers: int = 20,
                 scale_factor: float = 1.2, n_levels: int = 8):
    """S_cm mapping the candidate's camera frame into the current one.

    Returns (ok, R_cm, t_cm, s_cm, matched point-slot pairs (n, 2)) as host
    values; (False, None, None, 1.0, None) when rejected.  The whole
    candidate evaluation is device work (``compute_sim3_device``) read back
    in two packed transfers."""
    scal, ints = compute_sim3_device(
        state, cam, kf_cur, kf_cand, fix_scale=fix_scale, generator=generator, sets=sets,
        min_inliers=min_inliers, scale_factor=scale_factor, n_levels=n_levels)
    scal = scal.cpu().numpy()
    n_matches, success, n_final = int(scal[0]), bool(scal[1] > 0), int(scal[2])
    if n_matches < min_inliers or not success or n_final < min_inliers:
        return False, None, None, 1.0, None
    ints = ints.cpu().numpy()
    idx = np.where(ints[0] > 0)[0]
    pairs = np.stack([ints[1][idx], ints[2][idx]], axis=1)
    return True, scal[4:13].reshape(3, 3), scal[13:16], float(scal[3]), pairs


def compute_sim3_device(state, cam, kf_cur: int, kf_cand: int, *, fix_scale: bool,
                        generator=None, sets=None, min_inliers: int = 20,
                        scale_factor: float = 1.2, n_levels: int = 8):
    """The candidate evaluation on the device: mutual BoW-substitute match
    over the two keyframes' landmark features, RANSAC, masked Horn refit,
    SearchBySim3 growth (ORBmatcher.cc:1029-1245, called at
    LoopClosing.cc:262) and the joint refinement (OptimizeSim3).  Returns
    the packed (16,) float32 scalars [n_matches, success, n_final, s, R(9),
    t(3)] and (3, N) int32 [final inlier, current point slot, candidate
    point slot]."""
    K, N, P, O = state.capacity
    pt_c, pt_m = state.kf_point_idx[kf_cur], state.kf_point_idx[kf_cand]
    has_c = (pt_c >= 0) & state.kf_feat_valid[kf_cur]
    has_m = (pt_m >= 0) & state.kf_feat_valid[kf_cand]
    res = M.nn_match(hamming(state.kf_desc[kf_cur], state.kf_desc[kf_cand]),
                     row_valid=has_c, col_valid=has_m, max_dist=50, ratio=0.75,
                     mutual=True)
    n_matches = res.mask.sum(dtype=torch.int32)

    # camera-frame positions of the matched landmarks in each keyframe
    Tc, Tm = state.kf_pose[kf_cur], state.kf_pose[kf_cand]
    col = torch.clamp(res.idx, min=0).long()
    ptc_idx = torch.clamp(pt_c, min=0)
    p_c = se3.transform(Tc, state.pt_pos[ptc_idx.long()])
    p_m = se3.transform(Tm, state.pt_pos[torch.clamp(pt_m[col], min=0).long()])
    xn_c = _normalized(cam, state.kf_xy[kf_cur])
    xn_m = _normalized(cam, state.kf_xy[kf_cand][col])
    # chi2 9.21 x sigma2 in pixels, normalized (Sim3Solver.cc:85-86)
    sf = 1.2 ** torch.clamp(state.kf_octave[kf_cur], 0, 7).to(torch.float32)
    th1 = 9.21 * (sf / cam.fx) ** 2
    result = sim3_ransac(p_c, p_m, xn_c, xn_m, res.mask, generator, sets=sets,
                         fix_scale=fix_scale, chi2_th1=th1, chi2_th2=th1,
                         min_inliers=min_inliers)
    R_r, t_r, s_r = horn_sim3_masked(p_c, p_m, result.inliers, fix_scale=fix_scale)

    # grow the matches by mutual projection under the refit Sim3 before the
    # joint refinement: marginal loops start near the 20-match bar
    matched_col = set_rows(torch.zeros(N, dtype=torch.bool, device=res.idx.device),
                           torch.where(res.mask, res.idx, N), True)
    _, grow_cols = search_by_sim3(state, cam, kf_cur, kf_cand, R_r, t_r, s_r, res.mask,
                                  matched_col, scale_factor=scale_factor, n_levels=n_levels)
    comb_idx = torch.where(res.mask, res.idx, grow_cols)
    comb_mask = res.mask | (grow_cols >= 0)
    comb = torch.clamp(comb_idx, min=0).long()
    ptm_idx = torch.clamp(pt_m[comb], min=0)
    p_m2 = se3.transform(Tm, state.pt_pos[ptm_idx.long()])
    xn_m2 = _normalized(cam, state.kf_xy[kf_cand][comb])
    R_o, t_o, s_o, inlier_o = optimize_sim3(p_c, p_m2, xn_c, xn_m2, comb_mask, R_r, t_r, s_r,
                                            fix_scale=fix_scale, inv_sigma2=cam.fx ** 2,
                                            chi2_th=10.0)
    scal = torch.cat([
        torch.stack([n_matches.to(torch.float32), result.success.to(torch.float32),
                     inlier_o.sum().to(torch.float32), s_o.to(torch.float32)]),
        R_o.reshape(9), t_o,
    ])
    ints = torch.stack([inlier_o.to(torch.int32), ptc_idx.to(torch.int32),
                        ptm_idx.to(torch.int32)])
    return scal, ints


def _argmin_first(d: torch.Tensor, dim: int):
    """(min, the lowest index holding it) along ``dim``: a tie keeps the
    lowest index, as ``jnp.argmin`` does."""
    m = d.amin(dim=dim, keepdim=True)
    ids = torch.arange(d.shape[dim], device=d.device)
    ids = ids.reshape([-1 if a == dim % d.dim() else 1 for a in range(d.dim())])
    first = torch.where(d == m, ids, d.shape[dim]).amin(dim=dim)
    return m.squeeze(dim), first


def search_by_sim3(state, cam, kf_cur: int, kf_cand: int, R_cm, t_cm, s_cm,
                   existing_rows: torch.Tensor, existing_cols: torch.Tensor, *,
                   th: float = 7.5, max_dist: int = 100, scale_factor: float = 1.2,
                   n_levels: int = 8):
    """Grow loop matches by mutual projection under the current Sim3
    (ORBmatcher::SearchBySim3, ORBmatcher.cc:1029-1245): each keyframe's
    landmarks into the other image through S_cm or S_mc, windowed by the
    predicted octave's radius and band, keeping mutually agreeing
    descriptor matches among features not matched yet.  Returns (rows,
    cols) (N,) int32 of the new pairs, -1 elsewhere.  Each argmin keeps the
    lowest index on a tie."""
    K, N, P, O = state.capacity
    Tc, Tm = state.kf_pose[kf_cur], state.kf_pose[kf_cand]
    pt_c, pt_m = state.kf_point_idx[kf_cur], state.kf_point_idx[kf_cand]
    pc, pm = torch.clamp(pt_c, min=0).long(), torch.clamp(pt_m, min=0).long()
    has_c = (pt_c >= 0) & state.kf_feat_valid[kf_cur] & state.pt_valid[pc] & ~existing_rows
    has_m = (pt_m >= 0) & state.kf_feat_valid[kf_cand] & state.pt_valid[pm] & ~existing_cols
    sf = scale_factor ** torch.arange(n_levels, dtype=torch.float32, device=pc.device)

    def project(p_cam):
        z = torch.clamp(p_cam[:, 2], min=1e-6)
        u = cam.fx * p_cam[:, 0] / z + cam.cx
        v = cam.fy * p_cam[:, 1] / z + cam.cy
        ok = (p_cam[:, 2] > 1e-3) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        return torch.stack([u, v], dim=1), ok, torch.linalg.norm(p_cam, dim=1)

    # direction 1: candidate landmarks into the current image (rows = current)
    p_m_in_c = sim3.apply(R_cm, t_cm, s_cm, se3.transform(Tm, state.pt_pos[pm]))
    uv_m, ok_m, dist_m = project(p_m_in_c)
    pred_m = predict_scale(dist_m, state.pt_max_dist[pm] * s_cm, scale_factor, n_levels)
    r_m = th * sf[pred_m.long()]
    geo1 = M.window_mask(uv_m, state.kf_xy[kf_cur], r_m).T                # (Nc, Nm)
    # the predicted level's octave band (ORBmatcher.cc:1137-1142)
    band1 = M.octave_band_mask(pred_m, state.kf_octave[kf_cur], -1, 0).T

    # direction 2: current landmarks into the candidate image
    R_mc, t_mc, s_mc = sim3.inverse(R_cm, t_cm, s_cm)
    p_c_in_m = sim3.apply(R_mc, t_mc, s_mc, se3.transform(Tc, state.pt_pos[pc]))
    uv_c, ok_c, dist_c = project(p_c_in_m)
    pred_c = predict_scale(dist_c, state.pt_max_dist[pc] * s_mc, scale_factor, n_levels)
    r_c = th * sf[pred_c.long()]
    geo2 = M.window_mask(uv_c, state.kf_xy[kf_cand], r_c)                 # (Nc, Nm)
    band2 = M.octave_band_mask(pred_c, state.kf_octave[kf_cand], -1, 0)

    dmat = hamming(state.kf_desc[kf_cur], state.kf_desc[kf_cand])
    valid_pair = has_c[:, None] & has_m[None, :]
    d1 = torch.where(valid_pair & geo1 & band1 & ok_m[None, :], dmat, M.BIG)
    d2 = torch.where(valid_pair & geo2 & band2 & ok_c[:, None], dmat, M.BIG)
    min1, best_row_for_col = _argmin_first(d1, 0)                         # (Nm,)
    min2, best_col_for_row = _argmin_first(d2, 1)                         # (Nc,)
    # mutual agreement (ORBmatcher.cc:1226-1243)
    rows = torch.arange(N, dtype=torch.int32, device=pc.device)
    agree = ((min2 <= max_dist) & (min1 <= max_dist)[best_col_for_row]
             & (best_row_for_col[best_col_for_row] == rows))
    return (torch.where(agree, rows, -1),
            torch.where(agree, best_col_for_row.to(torch.int32), -1))


def build_essential_graph_edges(kf_parent: np.ndarray, covis: np.ndarray,
                                kf_valid: np.ndarray, loop_pairs, poses_R, poses_t,
                                poses_s, *, min_covis_weight: int = 100) -> PG.PoseGraphEdges:
    """The essential graph's topology (Optimizer.cc:796-1000) from host
    arrays: the spanning tree, covisibility edges of weight >= 100 and the
    given loop pairs, measured on the (pre-correction) poses."""
    ii, jj = [], []
    for k in range(len(kf_parent)):
        p = kf_parent[k]
        if kf_valid[k] and p >= 0 and kf_valid[p]:
            ii.append(int(p))
            jj.append(k)
    for a, b in np.argwhere(np.triu(covis, 1) >= min_covis_weight):
        if kf_valid[a] and kf_valid[b]:
            ii.append(int(a))
            jj.append(int(b))
    for a, b in loop_pairs:
        ii.append(int(a))
        jj.append(int(b))
    dev = poses_t.device
    ij = torch.tensor([ii, jj], dtype=torch.int32).to(dev)
    return PG.make_edges_from_poses(ij[0], ij[1], poses_R, poses_t, poses_s,
                                    torch.ones(len(ii), dtype=torch.bool, device=dev))


def _projection_jacobian(p: torch.Tensor) -> torch.Tensor:
    """d(x/z, y/z)/dp of (N, 3) points, (N, 2, 3), with z clamped at 1e-6."""
    z = torch.clamp(p[:, 2], min=1e-6)
    zero = torch.zeros_like(z)
    return torch.stack([torch.stack([1.0 / z, zero, -p[:, 0] / (z * z)], -1),
                        torch.stack([zero, 1.0 / z, -p[:, 1] / (z * z)], -1)], -2)


def _action_jacobian(p: torch.Tensor) -> torch.Tensor:
    """d(exp(zeta) p)/dzeta at zeta = 0 for (N, 3) points: [I, -hat(p), p],
    (N, 3, 7) (the W matrix of ``sim3.exp`` is the identity at zero)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return torch.cat([eye, -se3.hat(p), p[:, :, None]], dim=-1)


def optimize_sim3(p_c, p_m, xn_c, xn_m, valid, R0, t0, s0, *, fix_scale: bool,
                  inv_sigma2=1.0, chi2_th: float = 9.815, iters: int = 10):
    """Joint Sim3 refinement with projection residuals in both directions
    (Optimizer::OptimizeSim3, Optimizer.cc:1381-1573): S_cm p_m into the
    current image and S_cm^-1 p_c into the candidate's over the 7 (or 6)
    degrees of freedom, Huber-weighted, with a chi2 outlier drop between two
    LM runs as in the reference's two phases.  The update is left
    multiplicative, S <- exp(zeta) S, and the Jacobian at zeta = 0 is the
    closed form of the JAX package's ``jax.jacfwd``: d pi(exp(zeta) S p_m) =
    pi'(S p_m) [I, -hat(S p_m), S p_m], and since (exp(zeta) S)^-1 =
    S^-1 exp(-zeta), d pi(S^-1 exp(-zeta) p_c) = -pi'(S^-1 p_c) s^-1 R^T
    [I, -hat(p_c), p_c].  Steps are accepted on the device.  Returns (R, t,
    s, inlier mask)."""
    dtype, dev = t0.dtype, t0.device
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    keep = torch.ones(7, dtype=dtype, device=dev)
    keep[6:].fill_(0.0)
    keep7 = torch.diag(keep)
    J_c0 = _action_jacobian(p_c)                              # (N, 3, 7)

    def residuals(R, t, s):
        p_in_c = sim3.apply(R, t, s, p_m)
        rc = p_in_c[:, :2] / torch.clamp(p_in_c[:, 2], min=1e-6)[:, None] - xn_c
        Ri, ti, si = sim3.inverse(R, t, s)
        p_in_m = sim3.apply(Ri, ti, si, p_c)
        rm = p_in_m[:, :2] / torch.clamp(p_in_m[:, 2], min=1e-6)[:, None] - xn_m
        pos = (p_in_c[:, 2] > 1e-6) & (p_in_m[:, 2] > 1e-6)
        return torch.cat([rc, rm], dim=1), pos, p_in_c, p_in_m, Ri, si

    def jacobian(p_in_c, p_in_m, Ri, si):
        Jc = _projection_jacobian(p_in_c) @ _action_jacobian(p_in_c)
        Jm = -(_projection_jacobian(p_in_m) @ (si * Ri)) @ J_c0
        return torch.cat([Jc, Jm], dim=1)                      # (N, 4, 7)

    def chi2_of(r):
        return torch.sum(r * r, dim=1) * inv_sigma2

    def lm(R, t, s, active, n_iters):
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        for _ in range(n_iters):
            r0, pos, p_in_c, p_in_m, Ri, si = residuals(R, t, s)
            J = jacobian(p_in_c, p_in_m, Ri, si)
            chi2 = chi2_of(r0)
            hw = torch.where(chi2 <= 10.0, 1.0, torch.sqrt(10.0 / torch.clamp(chi2, min=1e-9)))
            w = torch.where(active & pos, inv_sigma2, 0.0) * hw
            Jw = J * w[:, None, None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            g = torch.einsum("nri,nr->i", Jw, r0)
            if fix_scale:
                H = keep7 @ H @ keep7 + (eye7 - keep7)
                g = keep7 @ g
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
            dz = -torch.linalg.solve_ex(Hd, g)[0]
            if fix_scale:
                dz = dz * keep
            Rn, tn, sn = sim3.compose(*sim3.exp(dz), R, t, s)
            r_new, pos_new = residuals(Rn, tn, sn)[:2]
            err_old = torch.sum(torch.where(active & pos, chi2, 0.0))
            err_new = torch.sum(torch.where(active & pos_new, chi2_of(r_new), 0.0))
            acc = err_new < err_old
            R, t, s = torch.where(acc, Rn, R), torch.where(acc, tn, t), torch.where(acc, sn, s)
            lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return R, t, s

    def inliers(R, t, s):
        r, pos = residuals(R, t, s)[:2]
        return valid & pos & (chi2_of(r) <= chi2_th)

    R, t, s = lm(R0, t0, s0, valid, iters // 2)
    R, t, s = lm(R, t, s, inliers(R, t, s), iters)
    return R, t, s, inliers(R, t, s)


def count_loop_projection_matches(state, cam, kf_cur: int, group_kf_mask: torch.Tensor,
                                  R_cw, t_cw, s_cw, *, budget: int = 2048,
                                  radius_px: float = 10.0, max_dist: int = 50) -> int:
    """The loop's final acceptance evidence (LoopClosing::ComputeSim3 tail,
    LoopClosing.cc:330-373): the ``budget`` nearest in-image landmarks of
    the loop keyframe's covisible group, projected into the current
    keyframe through the corrected Sim3, matched within ``radius_px``
    (the masked best-2 kernel on the card), one match per feature.  The
    reference accepts at >= 40.  The nearest points come from a stable
    descending sort, which keeps ``lax.top_k``'s order among equal values.
    One host read."""
    K, N, P, O = state.capacity
    kfc = torch.clamp(state.pt_obs_kf, min=0).long()
    in_group = group_kf_mask[kfc] & (state.pt_obs_kf >= 0)
    loop_pt = state.pt_valid & torch.any(in_group, dim=1)
    pc = sim3.apply(R_cw, t_cw, s_cw, state.pt_pos)
    z = pc[:, 2]
    z_ok = z > 1e-3
    z_safe = torch.where(z_ok, z, 1.0)
    u = cam.fx * pc[:, 0] / z_safe + cam.cx
    v = cam.fy * pc[:, 1] / z_safe + cam.cy
    ok = loop_pt & z_ok & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    top_score, top_idx = torch.sort(torch.where(ok, -z, -torch.inf), descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:budget], top_idx[:budget]
    uv_sel = torch.stack([u[top_idx], v[top_idx]], dim=-1)
    res = M.nn_match_desc(
        state.pt_desc[top_idx], state.kf_desc[kf_cur], row_valid=torch.isfinite(top_score),
        col_valid=state.kf_feat_valid[kf_cur],
        extra_mask=M.window_mask(uv_sel, state.kf_xy[kf_cur], radius_px), max_dist=max_dist)
    return int(M.resolve_duplicates(res, N).mask.sum())
