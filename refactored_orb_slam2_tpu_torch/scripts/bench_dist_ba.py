"""Sharded bundle adjustment: BA iterations per second against the number
of point shards (port of scripts/bench_dist_ba.py).

    python -m refactored_orb_slam2_tpu_torch.scripts.bench_dist_ba [--shards N] [--cpu]

The JAX bench's synthetic problem (``make_problem``: K 32 keyframes, P 16384
points, 6 observations each; 5 LM iterations of PCG) through
``parallel.dist_ba.run_distributed_ba`` at 1, N/2 and N shards.  The mesh
is every visible CUDA device when there are N or more, else one device
repeated N times: on a machine with one card the shards share it, so the
figure is the sharding's overhead, not scaling.  Hence the JSON line's
"retention", the sharded run's throughput over the unsharded one's, as the
JAX bench reports it for its virtual mesh.  Each shard count runs once to
warm up, then 3 times on the host clock with the device synchronized.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def make_problem(n_kf: int, n_pts: int, obs_per_pt: int, seed: int = 0, device="cpu"):
    """The JAX bench's problem: cameras along x with a slight yaw, points in
    front of them, observations with 0.5 px noise, points 5 cm off."""
    from refactored_orb_slam2_tpu_torch.geometry import se3
    from refactored_orb_slam2_tpu_torch.optim.bundle_adjustment import BAProblem

    rng = np.random.default_rng(seed)
    xi = np.zeros((n_kf, 6), np.float32)
    xi[:, 0] = -0.25 * np.arange(n_kf)
    xi[:, 4] = 0.01 * np.arange(n_kf)
    poses = se3.exp(torch.from_numpy(xi)).numpy()
    pts = np.stack(
        [rng.uniform(-4, 4 + 0.25 * n_kf, n_pts), rng.uniform(-3, 3, n_pts),
         rng.uniform(4, 15, n_pts)], axis=1,
    ).astype(np.float32)
    obs_kf = rng.integers(0, n_kf, (n_pts, obs_per_pt)).astype(np.int32)
    uvr = np.zeros((n_pts, obs_per_pt, 3), np.float32)
    for o in range(obs_per_pt):
        T = poses[obs_kf[:, o]]
        pc = np.einsum("nij,nj->ni", T[:, :3, :3], pts) + T[:, :3, 3]
        z = np.maximum(pc[:, 2], 0.5)
        u = 500 * pc[:, 0] / z + 320
        v = 500 * pc[:, 1] / z + 240
        uvr[:, o, 0] = u + rng.normal(0, 0.5, n_pts)
        uvr[:, o, 1] = v + rng.normal(0, 0.5, n_pts)
        uvr[:, o, 2] = u - 40.0 / z
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BAProblem(
        kf_poses=t(poses), kf_fixed=t(np.asarray([True] + [False] * (n_kf - 1))),
        kf_valid=t(np.ones(n_kf, bool)),
        points=t(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        point_valid=t(np.ones(n_pts, bool)), obs_kf=t(obs_kf), obs_uvr=t(uvr),
        obs_inv_sigma2=t(np.ones((n_pts, obs_per_pt), np.float32)),
        obs_is_stereo=t(np.ones((n_pts, obs_per_pt), bool)),
        obs_valid=t(np.ones((n_pts, obs_per_pt), bool)),
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kf", type=int, default=32)
    ap.add_argument("--pts", type=int, default=16384)
    ap.add_argument("--obs", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--shards", type=int, default=4, help="the largest shard count")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("bench_dist_ba: CUDA is not available; pass --cpu to run on the CPU")

    from refactored_orb_slam2_tpu_torch.geometry.camera import Camera
    from refactored_orb_slam2_tpu_torch.parallel import dist_ba
    from refactored_orb_slam2_tpu_torch.scripts.run_scale_demo import card

    device = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    visible = dist_ba.visible_devices(device)
    devices = visible if len(visible) >= args.shards else [visible[0]] * args.shards
    cam = Camera.create(500.0, 500.0, 320.0, 240.0, bf=40.0)
    prob = make_problem(args.kf, args.pts, args.obs, device=device)
    sync = (lambda: torch.cuda.synchronize()) if device.type == "cuda" else (lambda: None)

    rate = {}
    for n in sorted({1, max(1, args.shards // 2), args.shards}):
        mesh = dist_ba.make_mesh(devices=devices[:n])
        run = lambda: dist_ba.run_distributed_ba(cam, prob, mesh, iters_phase1=args.iters)
        run()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = run()
        sync()
        dt = (time.perf_counter() - t0) / args.reps
        assert torch.isfinite(out.kf_poses).all() and torch.isfinite(out.points).all()
        rate[n] = args.iters / dt
        print(f"shards={n}: {rate[n]:.2f} BA iters/s ({dt * 1e3:.1f} ms / {args.iters} iters)",
              flush=True)
    top = max(rate)
    distinct = len(set(devices[:top]))
    record = {
        "metric": "dist_ba_sharding_overhead_retention",
        "value": round(rate[top] / rate[1], 3),
        "shards": top,
        "distinct_devices": distinct,
        "iters_per_s": {str(k): round(v, 2) for k, v in rate.items()},
        "note": ("the shards share one device, so retention (sharded over unsharded "
                 "throughput) is the figure, not scaling" if distinct == 1 else
                 f"{distinct} devices"),
        "problem": {"K": args.kf, "P": args.pts, "O": args.obs, "lm_iters": args.iters},
        "device": card(device) or str(device),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
