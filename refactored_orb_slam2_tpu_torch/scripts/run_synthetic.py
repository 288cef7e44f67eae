"""Run the SLAM engine on a synthetic rendered sequence and report ATE (port
of scripts/run_synthetic.py: the same flags, world, trajectory and lines).

The equivalent of the reference's example binaries (mono_tum / stereo_kitti
/ rgbd_tum drivers, Source/Examples/*) without a dataset: renders a
textured world (``utils/synthetic.py``) along a ground-truth trajectory,
feeds frames to the engine, prints per-frame timing and final ATE, and
writes TUM and KITTI trajectory files. The system runs on the GPU; --cpu
runs it on the CPU instead (there is no fallback from one to the other).

Usage:
    python -m refactored_orb_slam2_tpu_torch.scripts.run_synthetic --sensor rgbd --frames 30 --out run1
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def config(sensor: str = "rgbd", features: int = 800, frames: int = 30):
    """The driver's system configuration: a 640x360 camera, ``features``
    ORB features on 4 levels, a map sized to the frame count."""
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    return SystemConfig(
        sensor=sensor,
        camera=CameraConfig(
            fx=450.0, fy=450.0, cx=320.0, cy=180.0, bf=225.0,
            width=640, height=360, fps=10,
        ),
        orb=ORBConfig(n_features=features, n_levels=4),
        map=MapConfig(
            max_keyframes=max(40, frames + 4), max_points=16384,
            max_obs_per_point=8,
        ),
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sensor", choices=["stereo", "rgbd"], default="rgbd")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--features", type=int, default=800)
    ap.add_argument("--motion", choices=["lateral", "forward"], default="lateral")
    ap.add_argument("--out", default="slam_run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, cuda)")
    args = ap.parse_args(argv)

    from refactored_orb_slam2_tpu_torch.geometry import se3
    from refactored_orb_slam2_tpu_torch.system import SlamSystem
    from refactored_orb_slam2_tpu_torch.utils.synthetic import SyntheticWorld, ate_rmse

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("run_synthetic: CUDA is not available; pass --cpu to run on the CPU")
    cfg = config(args.sensor, args.features, args.frames)
    world = SyntheticWorld.create(
        seed=3, n_points=800, x_range=(-10, 10), y_range=(-3, 3),
        z_range=(3.0, 14.0), clear_tube=0.0 if args.motion == "lateral" else 1.5,
    )
    if args.motion == "lateral":
        tw = [0.08, 0, 0, 0, 0, 0]
    else:
        tw = [0.0, 0, -0.1, 0, 0.003, 0]
    motion = se3.exp(torch.tensor(tw, dtype=torch.float32)).numpy()
    traj = [np.eye(4, dtype=np.float32)]
    for _ in range(args.frames - 1):
        traj.append(motion @ traj[-1])
    traj = np.stack(traj)

    sys_ = SlamSystem(cfg, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(1)
    times = []
    lost = 0
    for i, Tcw in enumerate(traj):
        if args.sensor == "stereo":
            L, R = world.render_stereo(Tcw, sys_.cam, noise=2.0, rng=rng)
            t0 = time.perf_counter()
            pose = sys_.track_stereo(L, R, i * 0.1)
        else:
            img = world.render(Tcw, sys_.cam, noise=2.0, rng=rng)
            depth = world.render_depth(Tcw, sys_.cam)
            t0 = time.perf_counter()
            pose = sys_.track_rgbd(img, depth, i * 0.1)
        sync()
        times.append(time.perf_counter() - t0)
        if pose is None:
            lost += 1

    sys_.shutdown()
    est = sys_.camera_centers()
    gt = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in traj])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    ate = ate_rmse(est, gt[sys_.tracked_frame_ids()])
    os.makedirs(args.out, exist_ok=True)
    sys_.export_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    sys_.export_trajectory_kitti(os.path.join(args.out, "trajectory_kitti.txt"))
    times = np.asarray(times[2:])
    print(f"sensor={args.sensor} frames={len(traj)} lost={lost} "
          f"keyframes={sys_.n_kf} points={sys_.n_pt}")
    print(f"track time: median={np.median(times)*1e3:.1f} ms "
          f"mean={times.mean()*1e3:.1f} ms")
    print(f"ATE RMSE: {ate:.4f} m over {path_len:.2f} m path")
    print(f"trajectories written to {args.out}/")
    return {"sensor": args.sensor, "frames": len(traj), "lost": lost, "n_kf": sys_.n_kf,
            "n_pt": sys_.n_pt, "median_ms": float(np.median(times) * 1e3),
            "mean_ms": float(times.mean() * 1e3), "ate_m": ate, "path_m": path_len}


if __name__ == "__main__":
    main()
