"""The plain reference that decides ``correct``: numpy only, nothing of the
program.

It judges what the timed path produced against what the benchmark made:

- trajectory: the association and the Umeyama alignment of
  ``scripts/evaluate.py`` (frozen copies), the RMS camera-centre error
  (ATE) per pass, and the frame-to-frame relative translation error (RPE);
  rigid for RGB-D and stereo, a similarity (``evaluate.py --scale``) for a
  monocular pass, whose map has the initializer's unit: its scale ``s``
  multiplies every distance read in the map;
- map: the keyframes' camera centres and the map points' distance to the
  nearest surface of the rendered scene, both after the pass's alignment;
- kernels: a plain Hamming best-2 (lowest column wins a tie; d2 equals d1
  when two columns tie; a row with no candidate gets d1 = d2 = BIG, i1 =
  0), with the window matcher's candidate test written out in float32.
"""

from __future__ import annotations

import numpy as np

#: the matchers' "no candidate" distance, as both kernels return it
BIG = 1 << 20

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


# ------------------------------------------------- scripts/evaluate.py (frozen)
def associate(ts_a, ts_b, max_dt=0.03):
    """Nearest-timestamp association -> (idx_a, idx_b)."""
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama(est, gt, with_scale=False):
    """Least-squares similarity/rigid alignment est -> gt.
    Returns (s, R, t) with gt ~= s * R @ est + t."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / len(E)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((E ** 2).sum() / len(E), 1e-12)) \
        if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


# ---------------------------------------------------------------- geometry
def centres(T_cw: np.ndarray) -> np.ndarray:
    """(n, 3) camera centres of (n, 4, 4) world->camera poses."""
    T = np.asarray(T_cw, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def surface_distance(points: np.ndarray, surfaces) -> np.ndarray:
    """(n,) distance of each point to the nearest rectangle (corner p0,
    perpendicular edges eu, ev)."""
    p = np.asarray(points, np.float64)
    best = np.full(len(p), np.inf)
    for s in surfaces:
        p0, eu, ev = (np.asarray(x, np.float64) for x in (s.p0, s.eu, s.ev))
        d = p - p0
        a = np.clip(d @ eu / (eu @ eu), 0.0, 1.0)
        b = np.clip(d @ ev / (ev @ ev), 0.0, 1.0)
        q = p0 + a[:, None] * eu + b[:, None] * ev
        best = np.minimum(best, np.linalg.norm(p - q, axis=1))
    return best


def judge_pass(run: dict, gt_Tcw: np.ndarray, stamps: np.ndarray, surfaces,
               with_scale: bool = False) -> dict:
    """One pass of the window against the ground truth it was rendered from.

    ``run``: ``ts`` (n,) and ``Tcw`` (n, 4, 4) of the tracked frames,
    ``kf_frame`` (k,) the frame each valid keyframe was made from and
    ``kf_Tcw`` (k, 4, 4) its pose in the map, ``points`` (m, 3) the valid
    map points.  ``with_scale``: align by a similarity (a monocular map),
    else rigidly.  Returns the alignment's scale, the squared centre errors
    of the frames (metres^2), the RPE of consecutive tracked frames
    (metres), the keyframes' centre errors and the points' surface
    distances (metres)."""
    ie, ig = associate(run["ts"], stamps)
    out = dict(n_tracked=int(len(ie)), scale=float("nan"), sq_err=np.zeros(0),
               rpe=np.zeros(0), kf_err=np.zeros(0), pt_dist=np.zeros(0))
    if len(ie) < 3:
        return out
    est, gt = np.asarray(run["Tcw"], np.float64)[ie], gt_Tcw[ig]
    # rigid: s is 1.0, and scaling by it is exact
    s, R, t = umeyama(centres(est), centres(gt), with_scale=with_scale)
    place = lambda x: s * x @ R.T + t
    out["scale"] = s
    aligned = place(centres(est))
    out["sq_err"] = ((aligned - centres(gt)) ** 2).sum(1)
    consecutive = np.flatnonzero(np.diff(ig) == 1)
    if len(consecutive):
        # camera k+1 -> camera k: the same whatever frame the map is in, up
        # to the map's unit
        inv = np.linalg.inv
        rel_e = est[consecutive] @ inv(est[consecutive + 1])
        rel_e[:, :3, 3] *= s
        rel_g = gt[consecutive] @ inv(gt[consecutive + 1])
        out["rpe"] = np.linalg.norm((inv(rel_g) @ rel_e)[:, :3, 3], axis=1)
    if len(run["kf_frame"]):
        kf_c = place(centres(run["kf_Tcw"]))
        out["kf_err"] = np.linalg.norm(kf_c - centres(gt_Tcw[run["kf_frame"]]), axis=1)
    if len(run["points"]):
        out["pt_dist"] = surface_distance(place(np.asarray(run["points"], np.float64)),
                                          surfaces)
    return out


# ----------------------------------------------------------------- kernels
def round_mantissa(x, bits: int) -> np.ndarray:
    """``x`` in float32, rounded to nearest (ties to even) with ``bits``
    explicit mantissa bits: 10 is TF32's, 7 bfloat16's."""
    x = np.ascontiguousarray(x, np.float32)
    drop = 23 - bits
    if drop <= 0:
        return x
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + (1 << (drop - 1)) - 1 + ((u >> drop) & 1)) >> drop) << drop
    return u.astype(np.uint32).view(np.float32)


def window_candidates(uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t, band,
                      bits: int = 23):
    """The window matcher's candidate pairs (rows, cols): both valid,
    |du| <= r and |dv| <= r in float32 (or, for the control, with every
    value and difference rounded to ``bits`` mantissa bits),
    lo <= oct_t - oct_q <= hi."""
    low = lambda v: round_mantissa(v, bits)
    uv_q, uv_t = low(np.asarray(uv_q, np.float32)), low(np.asarray(uv_t, np.float32))
    r = low(np.asarray(radius, np.float32))
    du = low(np.abs(uv_q[:, None, 0] - uv_t[None, :, 0]))
    dv = low(np.abs(uv_q[:, None, 1] - uv_t[None, :, 1]))
    d_oct = np.asarray(oct_t, np.int64)[None, :] - np.asarray(oct_q, np.int64)[:, None]
    ok = ((du <= r[:, None]) & (dv <= r[:, None]) & (d_oct >= band[0]) & (d_oct <= band[1])
          & np.asarray(valid_q, bool)[:, None] & np.asarray(valid_t, bool)[None, :])
    return np.nonzero(ok)


def best2(desc_a, desc_b, rows, cols, n_rows):
    """Per row of ``desc_a`` (n, 8) int32 words: (d1, i1, d2) over the
    candidate pairs (rows, cols) into ``desc_b``."""
    a = np.ascontiguousarray(desc_a, np.int32).view(np.uint8).reshape(len(desc_a), 32)
    b = np.ascontiguousarray(desc_b, np.int32).view(np.uint8).reshape(len(desc_b), 32)
    d = _POPCOUNT8[a[rows] ^ b[cols]].sum(1)
    d1 = np.full(n_rows, BIG, np.int64)
    i1 = np.zeros(n_rows, np.int64)
    d2 = np.full(n_rows, BIG, np.int64)
    if len(rows):
        order = np.lexsort((cols, d, rows))          # by row, then distance, then column
        r, dd, cc = rows[order], d[order], cols[order]
        first = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        d1[r[first]], i1[r[first]] = dd[first], cc[first]
        second = first + 1
        has2 = second < len(r)
        has2[has2] &= r[second[has2]] == r[first[has2]]
        d2[r[first[has2]]] = dd[second[has2]]
    return d1, i1, d2


def wrong_rows(call: dict) -> int:
    """Rows of one recorded kernel call whose (d1, i1, d2) differ from the
    plain best-2 of the call's own inputs."""
    a = call["args"]
    if call["name"] == "window_match":
        desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t = a
        rows, cols = window_candidates(uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t,
                                       call["band"])
        desc_a, desc_b = desc_q, desc_t
    else:
        desc_a, desc_b, mask = a
        rows, cols = np.nonzero(np.asarray(mask, bool))
    ref = best2(desc_a, desc_b, rows, cols, len(desc_a))
    got = [np.asarray(x, np.int64) for x in call["out"]]
    return int(np.count_nonzero((got[0] != ref[0]) | (got[1] != ref[1]) | (got[2] != ref[2])))

