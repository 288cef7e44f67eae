"""Scale demonstration (port of scripts/run_scale_demo.py): a long stereo
run at KITTI-scale capacities, K = 2048 keyframes and P = 262144 points with
16 observations each, with the whole pipeline and loop closing on.  It
shows (a) what mapping a keyframe costs as the map grows, (b) that no
capacity warning fires and (c) that a loop at this bank size closes through
the matrix-free PCG pose graph (``optim/pose_graph.py``, chosen above
``MapConfig.pose_graph_dense_max`` = 512, where the dense (K, K, 7, 7)
assembly would be ~822 MB an iteration).

    python -m refactored_orb_slam2_tpu_torch.scripts.run_scale_demo [--frames N] [--cpu]

The JAX demo's set-up: the street circuit ``scene_street(seed=41, block=30,
road_w=8)`` and ``traj_street_loop(seed=41)`` over ``frames / 140`` laps,
rendered with the true focal 320 and noise 2.0 from ``default_rng(6)`` and
tracked with a focal 4 px off (fx = fy = 324), so that drift builds up and
the revisit is a loop to detect; 320x240, bf 120, 1000 features, 4 levels;
local BA over 64 keyframes and 8192 points; pipelined dispatch.  Frames are
rendered on the system's device (``render_stereo_device``) just before
each is tracked.  A keyframe's mapping is timed around ``_mapping_pipeline``
with the device synchronized at its end; the global BA and the pose graph
are timed the same way, with the loop correction around them
(``_correct_loop``); each call of ``track_stereo_device`` on the host clock
as its caller waits (a pipelined call returns once its frame is
dispatched).  A frame counts as lost when its log says so (a pipelined
call returns before its frame is judged).

Prints one JSON line with the JAX demo's keys, the card's name and power
limit, the frame times and the wall times of each global BA, loop
correction and pose graph, and writes it to
``scale_demo.json`` in the temporary directory, where the JAX demo writes
it.  The run is on the GPU; ``--cpu`` runs it on the CPU.  Without CUDA and
without ``--cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BLOCK, ROAD_W = 30.0, 8.0
FRAMES_PER_LAP = 140.0
F_TRUE = 320.0
DF = 4.0   # the tracker's focal error (px): real metric drift round the circuit,
           # so that the revisit is not already covisible and detection fires
           # (as tests/test_loop_e2e.py; with a perfect focal the reference would
           # suppress detection too, KeyFrameDatabase.cc:91-99)


def scale_config(map_cfg=None):
    """The demo's stereo camera and ORB settings on ``map_cfg``, by default
    the KITTI-scale map (2048 x 262144 x 16, local BA 64 x 8192)."""
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    if map_cfg is None:
        map_cfg = MapConfig(max_keyframes=2048, max_points=262144, max_obs_per_point=16,
                            local_ba_max_kfs=64, local_ba_max_points=8192)
    f = F_TRUE + DF
    return SystemConfig(
        sensor="stereo",
        camera=CameraConfig(fx=f, fy=f, cx=160.0, cy=120.0, bf=120.0, width=320, height=240,
                            fps=10),
        orb=ORBConfig(n_features=1000, n_levels=4),
        map=map_cfg,
    )


def card(device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _timed(owner, name: str, device, into: list):
    """``owner.name`` timed into ``into`` (seconds, the device synchronized
    at its end) while the block runs."""
    inner = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        _sync(device)
        into.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, inner)


def run(frames: int, device, map_cfg=None, progress: bool = False) -> dict:
    """The demo over ``frames`` frames on ``device``; returns its record."""
    from refactored_orb_slam2_tpu_torch import system as S
    from refactored_orb_slam2_tpu_torch.geometry.camera import Camera
    from refactored_orb_slam2_tpu_torch.utils import telemetry
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    device = torch.device(device)
    telemetry.reset()       # the record's warnings are this run's
    cfg = scale_config(map_cfg)
    cam_true = Camera.create(F_TRUE, F_TRUE, 160.0, 120.0, bf=120.0, width=320, height=240)
    slam = S.SlamSystem(cfg, device=device, pipelined=True)
    world = W.scene_street(seed=41, block=BLOCK, road_w=ROAD_W)
    poses = W.traj_street_loop(frames, block=BLOCK, road_w=ROAD_W, seed=41,
                               laps=frames / FRAMES_PER_LAP)
    rng = np.random.default_rng(6)

    map_s, gba_s, graph_s, correct_s, frame_s = [], [], [], [], []
    _sync(device)
    t_all = time.perf_counter()
    with _timed(slam, "_mapping_pipeline", device, map_s), \
            _timed(slam, "_launch_gba", device, gba_s), \
            _timed(slam, "_correct_loop", device, correct_s), \
            _timed(S.PG, "optimize_pose_graph", device, graph_s):
        for i, Tcw in enumerate(poses):
            left, right = world.render_stereo_device(Tcw, cam_true, noise=2.0, rng=rng,
                                                     device=device)
            t0 = time.perf_counter()
            slam.track_stereo_device(left, right, i * 0.1)
            frame_s.append(time.perf_counter() - t0)
            if progress and (i + 1) % 100 == 0:
                print(f"  frame {i + 1}/{frames}: kf={slam.n_kf} pt={slam.n_pt}", flush=True)
        slam.flush_pipeline()
    _sync(device)
    wall = time.perf_counter() - t_all

    mt, ft = np.asarray(map_s), np.asarray(frame_s)
    third = max(len(mt) // 3, 1)
    ms = lambda part: round(float(np.median(part)) * 1e3, 1) if len(part) else None
    each_ms = lambda times: [round(t * 1e3, 1) for t in times]
    return dict(
        frames=frames, lost=frames - len(slam.tracked_logs()), keyframes=slam.n_kf,
        points=slam.n_pt, wall_s=round(wall, 1),
        mapping_ms_per_kf=dict(first_third=ms(mt[:third]), middle_third=ms(mt[third:2 * third]),
                               last_third=ms(mt[2 * third:])),
        loop_closed=bool((slam.map.kf_loop_edges >= 0).any()),
        gba_runs=slam.stats["gba_runs"],
        pose_graph_solver=("pcg" if cfg.map.max_keyframes > cfg.map.pose_graph_dense_max
                           else "dense"),
        capacity_warnings=telemetry.warned_keys(),
        frame_ms=dict(median=ms(ft), mean=round(float(ft.mean()) * 1e3, 1)),
        gba_ms=each_ms(gba_s), correct_loop_ms=each_ms(correct_s),
        pose_graph_ms=each_ms(graph_s),
        device=card(device) or str(device),
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=700, help="frames (140 a lap; default 700)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("run_scale_demo: CUDA is not available; pass --cpu to run on the CPU")
    out = run(args.frames, "cpu" if args.cpu else "cuda", progress=True)
    print(json.dumps(out))
    with open(os.path.join(tempfile.gettempdir(), "scale_demo.json"), "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
