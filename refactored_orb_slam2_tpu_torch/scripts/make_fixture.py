"""Write rendered dataset fixtures in the native TUM, KITTI and EuRoC layouts
(port of scripts/make_fixture.py: the same three generators, layouts, file
names, seeds, default frame counts and command line).

No real dataset ships with the repo, so the head-to-head rows of
BASELINE.md run on deterministic raycast-rendered sequences written to disk
in each dataset's own format, then read through the dataset readers and the
driver (``scripts/run_dataset.py``) as a user would run real data.

Fixtures (calibration from the port's ``utils/presets.py``, so ``--preset``
works unchanged):
    tum_room    TUM RGB-D layout (rgb/, depth/ uint16 PNG x5000, rgb.txt,
                depth.txt, groundtruth.txt), 640x480 @ 30 fps, fr3 pinhole
                (``rgbd_tum3``). Handheld desk orbit (fr1/desk-style).
    kitti_loop  KITTI odometry layout (sequences/00/image_{0,1}, times.txt,
                poses/00.txt), 1241x376 @ 10 fps, KITTI-00 calibration.
                Rectangular city-block circuit with loop closure.
    euroc_hall  EuRoC MAV layout (mav0/cam{0,1}/data/<ns>.png), 752x480
                @ 20 fps, rectified stereo (bf = 47.906), rendered already
                rectified: run with --preset stereo_euroc and --no-rect.
                Ellipse flight in a machine hall (MH01-style).

Frames render with the port's ``utils/world3d.py`` on the GPU (``--cpu``:
on the CPU; no fallback from one to the other) and are written by the
port's PNG codec (``io/png.py``). A generator given ``first`` writes only
the first ``first`` frames of the ``n_frames`` trajectory (its lists and
ground truth too): the start of the full-length sequence, at its speed.

Usage:
    python -m refactored_orb_slam2_tpu_torch.scripts.make_fixture tum_room --frames 600 --out fix/tum_room
    python -m refactored_orb_slam2_tpu_torch.scripts.make_fixture kitti_loop --frames 400 --out fix/kitti
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from refactored_orb_slam2_tpu_torch.geometry import se3
from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
from refactored_orb_slam2_tpu_torch.io.png import write_png
from refactored_orb_slam2_tpu_torch.utils import world3d as W
from refactored_orb_slam2_tpu_torch.utils.presets import get_preset


def _quat_of(Twc):
    return se3.to_quaternion(torch.from_numpy(np.asarray(Twc[:3, :3], np.float32))).numpy()


def _progress(i, n_frames, t_start):
    if (i + 1) % 100 == 0:
        print(f"  {i + 1}/{n_frames} frames "
              f"({(time.time() - t_start) / (i + 1) * 1e3:.0f} ms/frame)", flush=True)


def write_tum_gt(path, stamps, poses_cw):
    """groundtruth.txt: timestamp tx ty tz qx qy qz qw (camera->world)."""
    with open(path, "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for t, Tcw in zip(stamps, poses_cw):
            Twc = np.linalg.inv(Tcw)
            q = _quat_of(Twc)
            p = Twc[:3, 3]
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def gen_tum_room(out, n_frames, seed=11, device="cuda", first=None):
    cfg = get_preset("rgbd_tum3")
    cam = camera_from_config(cfg.camera)
    world = W.scene_room(seed=seed)
    poses = W.traj_room_orbit(n_frames, seed=seed)[:first]
    fps = 30.0
    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    stamps = 1_300_000_000.0 + np.arange(len(poses)) / fps
    rgb_lines, depth_lines = [], []
    t_start = time.time()
    for i, Tcw in enumerate(poses):
        img, depth = world.render(Tcw, cam, want_depth=True, noise=2.0, rng=rng,
                                  device=device)
        ts = stamps[i]
        rgb_name = f"rgb/{ts:.6f}.png"
        depth_name = f"depth/{ts:.6f}.png"
        write_png(os.path.join(out, rgb_name), img.astype(np.uint8))
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(out, depth_name), d16)
        rgb_lines.append(f"{ts:.6f} {rgb_name}")
        depth_lines.append(f"{ts:.6f} {depth_name}")
        _progress(i, len(poses), t_start)
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines)):
        with open(os.path.join(out, name), "w") as f:
            f.write("# fixture\n# timestamp filename\n")
            f.write("\n".join(lines) + "\n")
    write_tum_gt(os.path.join(out, "groundtruth.txt"), stamps, poses)


def gen_kitti_loop(out, n_frames, seed=23, device="cuda", first=None):
    cfg = get_preset("stereo_kitti00")
    cam = camera_from_config(cfg.camera)
    block, road_w = 60.0, 14.0
    world = W.scene_street(seed=seed, block=block, road_w=road_w)
    poses = W.traj_street_loop(n_frames, block=block, road_w=road_w, seed=seed)[:first]
    seq = os.path.join(out, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(out, "poses"), exist_ok=True)
    rng = np.random.default_rng(seed)
    fps = 10.0
    t_start = time.time()
    with open(os.path.join(seq, "times.txt"), "w") as f:
        for i in range(len(poses)):
            f.write(f"{i / fps:.6e}\n")
    pose_lines = []
    T0_inv = None
    for i, Tcw in enumerate(poses):
        L, R = world.render_stereo(Tcw, cam, noise=2.0, rng=rng, device=device)
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), L.astype(np.uint8))
        write_png(os.path.join(seq, "image_1", f"{i:06d}.png"), R.astype(np.uint8))
        Twc = np.linalg.inv(Tcw)
        if T0_inv is None:
            T0_inv = np.linalg.inv(Twc)
        rel = T0_inv @ Twc          # KITTI gt is relative to the first frame
        pose_lines.append(" ".join(f"{v:.6e}" for v in rel[:3, :4].reshape(-1)))
        _progress(i, len(poses), t_start)
    with open(os.path.join(out, "poses", "00.txt"), "w") as f:
        f.write("\n".join(pose_lines) + "\n")
    # TUM-format gt too, for the unified evaluator
    stamps = np.arange(len(poses)) / fps
    write_tum_gt(os.path.join(seq, "groundtruth.txt"), stamps, poses)


def gen_euroc_hall(out, n_frames, seed=31, device="cuda", first=None):
    cfg = get_preset("stereo_euroc")
    cam = camera_from_config(cfg.camera)
    world = W.scene_hall(seed=seed)
    poses = W.traj_hall_ellipse(n_frames, seed=seed)[:first]
    mav = os.path.join(out, "mav0")
    os.makedirs(os.path.join(mav, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "cam1", "data"), exist_ok=True)
    rng = np.random.default_rng(seed)
    fps = 20.0
    stamps_ns = (1.4e18 + np.arange(len(poses)) / fps * 1e9).astype(np.int64)
    t_start = time.time()
    for i, Tcw in enumerate(poses):
        L, R = world.render_stereo(Tcw, cam, noise=2.0, rng=rng, device=device)
        name = f"{stamps_ns[i]:d}.png"
        write_png(os.path.join(mav, "cam0", "data", name), L.astype(np.uint8))
        write_png(os.path.join(mav, "cam1", "data", name), R.astype(np.uint8))
        _progress(i, len(poses), t_start)
    write_tum_gt(os.path.join(mav, "groundtruth.txt"),
                 stamps_ns.astype(np.float64) * 1e-9, poses)


FIXTURES = {
    "tum_room": (gen_tum_room, 600),
    "kitti_loop": (gen_kitti_loop, 400),
    "euroc_hall": (gen_euroc_hall, 500),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("fixture", choices=sorted(FIXTURES))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the GPU, cuda)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("make_fixture: CUDA is not available; pass --cpu to render on the CPU")
    gen, default_frames = FIXTURES[args.fixture]
    kwargs = {"device": device}
    if args.seed is not None:
        kwargs["seed"] = args.seed
    os.makedirs(args.out, exist_ok=True)
    gen(args.out, args.frames or default_frames, **kwargs)
    print(f"fixture {args.fixture} written to {args.out}")


if __name__ == "__main__":
    main()
