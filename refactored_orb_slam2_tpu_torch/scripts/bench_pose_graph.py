"""Pose-graph solver at scale: dense against matrix-free PCG (port of
scripts/bench_pose_graph.py).

    python -m refactored_orb_slam2_tpu_torch.scripts.bench_pose_graph [--cpu]

The JAX bench's graph at K in {512, 1024, 2048}: keyframes on a circle
whose estimate drifts (``circle_graph``, drift 0.015, seed 5; the port's own
copy of the fixture in ``tests/test_pose_graph.py``), chain edges, the loop
edge and covisibility-style skip edges k -> k + 4, the essential graph's
shape after a loop closure (Optimizer.cc:763-1362).  The dense solver runs
only at K = 512, where the system would choose it; above, its (K, K, 7, 7)
assembly is 645 MB (K = 1024) to 2.6 GB (K = 2048) a buffer.  Prints one
JSON line per (K, solver): wall ms per solve of 20 LM iterations (the
reference's budget, Optimizer.cc:989; one warm-up, then 3 on the host clock
with the device synchronized) and the largest camera-centre error before
and after.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def circle_graph(n=24, drift=0.02, scale_drift=0.0, seed=0):
    """Ground truth: keyframes on a circle.  The estimate chains the true
    relative poses with noise, so that the loop does not close (a copy of
    ``tests/test_pose_graph.py::circle_graph`` on the port's SO(3) map)."""
    from refactored_orb_slam2_tpu_torch.geometry import se3

    so3 = lambda phi: se3.so3_exp(torch.from_numpy(np.asarray(phi, np.float32))).numpy()
    rng = np.random.default_rng(seed)
    R_gt, t_gt, s_gt = [], [], []
    for k in range(n):
        ang = 2 * np.pi * k / n
        Rw = so3([0.0, ang, 0.0])
        Cw = np.asarray([5 * np.sin(ang), 0.0, 5 - 5 * np.cos(ang)], np.float32)
        R = Rw.T
        R_gt.append(R)
        t_gt.append(-R @ Cw)
        s_gt.append(1.0)
    R_gt, t_gt, s_gt = np.stack(R_gt), np.stack(t_gt), np.asarray(s_gt, np.float32)

    R_est, t_est, s_est = [R_gt[0]], [t_gt[0]], [1.0]
    for k in range(1, n):
        Rr = R_gt[k] @ R_gt[k - 1].T
        tr = t_gt[k] - Rr @ t_gt[k - 1]
        noise = rng.normal(0, drift, 3).astype(np.float32)
        Rn = so3(noise * 0.3)
        s_mult = float(np.exp(rng.normal(0, scale_drift)))
        R_est.append((Rn @ Rr @ R_est[-1]).astype(np.float32))
        t_est.append((s_mult * (Rn @ (Rr @ t_est[-1] + tr)) + noise * 0.5).astype(np.float32))
        s_est.append(s_est[-1] * s_mult)
    return (R_gt, t_gt, s_gt), (np.stack(R_est), np.stack(t_est), np.asarray(s_est, np.float32))


def build_graph(n: int):
    ii = [k - 1 for k in range(1, n)] + [n - 1]
    jj = list(range(1, n)) + [0]
    for k in range(0, n - 4, 2):       # covisibility-style skip edges
        ii.append(k)
        jj.append(k + 4)
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def centers(R, t, s) -> np.ndarray:
    return -np.einsum("kji,kj->ki", R, t) / s[:, None]


def run_one(n: int, solver: str, device, n_iters: int = 20, reps: int = 3) -> dict:
    from refactored_orb_slam2_tpu_torch.optim.pose_graph import (
        make_edges_from_poses, optimize_pose_graph,
    )

    (R_gt, t_gt, s_gt), (R_est, t_est, s_est) = circle_graph(n, drift=0.015, seed=5)
    ii, jj = build_graph(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    edges = make_edges_from_poses(t(ii), t(jj), t(R_gt), t(t_gt), t(s_gt),
                                  torch.ones(len(ii), dtype=torch.bool, device=device))
    fixed = torch.zeros(n, dtype=torch.bool, device=device)
    fixed[0:1].fill_(True)
    args = (t(R_est), t(t_est), t(s_est), torch.ones(n, dtype=torch.bool, device=device),
            fixed, edges)
    sync = (lambda: torch.cuda.synchronize()) if device.type == "cuda" else (lambda: None)

    solve = lambda: optimize_pose_graph(*args, fix_scale=True, solver=solver, n_iters=n_iters)
    solve()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        R, tt, s = solve()
    sync()
    ms = (time.perf_counter() - t0) / reps * 1e3
    c_gt = centers(R_gt, t_gt, s_gt)
    e_before = float(np.linalg.norm(centers(R_est, t_est, s_est) - c_gt, axis=1).max())
    e_after = float(np.linalg.norm(centers(R.cpu().numpy(), tt.cpu().numpy(),
                                           s.cpu().numpy()) - c_gt, axis=1).max())
    rec = {"K": n, "edges": int(len(ii)), "solver": solver, "lm_iters": n_iters,
           "wall_ms_per_solve": round(ms, 1), "max_center_err_before_m": round(e_before, 4),
           "max_center_err_after_m": round(e_after, 4), "converged": e_after < 0.15 * e_before}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024, 2048])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("bench_pose_graph: CUDA is not available; pass --cpu to run on the CPU")
    from refactored_orb_slam2_tpu_torch.scripts.run_scale_demo import card

    device = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {card(device) or device}", flush=True)
    recs = []
    for n in args.sizes:
        if n <= 512:
            recs.append(run_one(n, "dense", device))
        recs.append(run_one(n, "pcg", device))
    if not all(r["converged"] for r in recs):
        raise AssertionError(recs)
    return recs


if __name__ == "__main__":
    main()
