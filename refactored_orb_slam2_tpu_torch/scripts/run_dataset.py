"""Dataset drivers: the six reference example binaries as one CLI (port of
scripts/run_dataset.py).

Mirrors Source/Examples/{Monocular,Stereo,RGB-D}: mono_tum, mono_kitti,
mono_euroc, stereo_kitti, stereo_euroc, rgbd_tum — load a sequence, pump
frames through the SLAM engine, report median/mean per-frame tracking time
(mono_tum.cc:133-140), and save the trajectory (TUM format; KITTI format
too for KITTI modes, System.cc:355-507).

Usage:
    python -m refactored_orb_slam2_tpu_torch.scripts.run_dataset rgbd_tum --data /path/to/rgbd_dataset_freiburg1_desk
    python -m refactored_orb_slam2_tpu_torch.scripts.run_dataset stereo_kitti --data /path/to/sequences/00
    python -m refactored_orb_slam2_tpu_torch.scripts.run_dataset mono_euroc --data /path/to/MH_01/mav0
    python -m refactored_orb_slam2_tpu_torch.scripts.run_dataset mono_tum --data ... --settings TUM1.yaml

Calibration comes from --preset (auto-chosen per mode: TUM variant from
--variant, KITTI group from the sequence number in --data) or from a
reference-format --settings YAML.  The system runs on the GPU; --cpu runs
it on the CPU instead (there is no fallback from one to the other).
PNG sequences are read by the port's own codec (io/png.py, no cv2);
--overlay-every needs matplotlib.  --coop
runs cooperative mapping with pipelined dispatch at --depth, --pipelined
pipelined dispatch at depth 1, --async-mapping local mapping and loop
closing on worker threads (the JAX driver's flags).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

from refactored_orb_slam2_tpu_torch.config import load_settings
from refactored_orb_slam2_tpu_torch.io import datasets as D
from refactored_orb_slam2_tpu_torch.utils import presets as P

MODES = ("mono_tum", "mono_kitti", "mono_euroc",
         "stereo_kitti", "stereo_euroc", "rgbd_tum")


def _sensor(mode: str) -> str:
    return {"mono": "monocular", "stereo": "stereo", "rgbd": "rgbd"}[
        mode.split("_")[0]
    ]


def _guess_kitti_seq(data: str) -> int:
    m = re.search(r"(\d\d)/?$", data.rstrip("/"))
    return int(m.group(1)) if m else 0


def _config(args):
    sensor = _sensor(args.mode)
    if args.settings:
        return load_settings(args.settings, sensor=sensor)
    if args.preset:
        return P.get_preset(args.preset)
    if "kitti" in args.mode:
        return P.kitti_preset_for_sequence(_guess_kitti_seq(args.data), sensor)
    if "euroc" in args.mode:
        return P.get_preset(f"{args.mode.split('_')[0]}_euroc")
    return P.get_preset(f"{args.mode.split('_')[0]}_tum{args.variant}")


def _sequence(args, cfg):
    if args.mode == "mono_tum":
        return D.TumMonoSequence(args.data)
    if args.mode == "mono_kitti":
        return D.KittiMonoSequence(args.data)
    if args.mode == "mono_euroc":
        return D.EurocMonoSequence(args.data)
    if args.mode == "stereo_kitti":
        return D.KittiStereoSequence(args.data)
    if args.mode == "stereo_euroc":
        rect = None if args.no_rect else P.EUROC_RECTIFICATION
        return D.EurocStereoSequence(args.data, rect=rect)
    if args.mode == "rgbd_tum":
        return D.TumRgbdSequence(
            args.data, depth_factor=cfg.tracking.depth_map_factor
        )
    raise ValueError(args.mode)


def track_frames(slam, frames, *, max_frames: int | None = None,
                 localization_after: int = 0, overlay_every: int = 0,
                 overlay_dir: str = "overlays", progress: bool = True) -> list[float]:
    """The driver's per-frame loop: every ``(t, img[, depth | right])`` host
    frame of ``frames`` (a dataset reader or any iterable) through the
    system's host entry point for its sensor; returns each call's seconds
    (host clock, the device synchronized at its end).  Stops after
    ``max_frames``; switches to localization-only mode after
    ``localization_after`` frames; draws an overlay every
    ``overlay_every`` frames into ``overlay_dir``.  The synchronize is the
    calling thread's stream's: in async mode the workers' streams run on."""
    sensor = slam.sensor
    sync = ((lambda: torch.cuda.current_stream(slam.device).synchronize())
            if slam.device.type == "cuda" else (lambda: None))
    times = []
    n = 0
    for item in frames:
        t0 = time.perf_counter()
        if sensor == "rgbd":
            ts, img, depth = item
            slam.track_rgbd(img, depth, ts)
        elif sensor == "stereo":
            ts, img, right = item
            slam.track_stereo(img, right, ts)
        else:
            ts, img = item
            slam.track_monocular(img, ts)
        sync()
        times.append(time.perf_counter() - t0)
        n += 1
        if overlay_every and n % overlay_every == 0:
            from refactored_orb_slam2_tpu_torch.io import viz

            os.makedirs(overlay_dir, exist_ok=True)
            gray = np.asarray(img)
            if gray.ndim == 3:
                gray = gray.mean(axis=-1)
            viz.draw_frame(os.path.join(overlay_dir, f"frame_{n:06d}.png"),
                           slam, gray, frame_no=n)
        if localization_after and n == localization_after:
            slam.activate_localization_mode()
        if max_frames and n >= max_frames:
            break
        if progress and n % 100 == 0:
            print(f"  frame {n}  median track {np.median(times) * 1e3:.1f} ms",
                  flush=True)
    return times


def main(argv=None) -> dict:
    """Run the driver; prints its lines and returns the summary of its last
    (JSON) line with the mean frame time, n_kf and n_pt added."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("--data", required=True, help="sequence root directory")
    ap.add_argument("--settings", help="reference-format settings YAML")
    ap.add_argument("--preset", help=f"named preset ({', '.join(P.preset_names())})")
    ap.add_argument("--variant", type=int, default=1,
                    help="TUM freiburg variant 1/2/3 (default 1)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-rect", action="store_true",
                    help="skip EuRoC stereo rectification (fixture sequences "
                         "are rendered already-rectified)")
    ap.add_argument("--out", default="trajectory.txt",
                    help="trajectory output path (TUM format)")
    ap.add_argument("--out-kf", default=None, help="keyframe trajectory path")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local mapping / loop closing on worker threads "
                         "(each on its own CUDA stream on the GPU)")
    ap.add_argument("--coop", action="store_true",
                    help="cooperative mapping: bounded mapping steps pumped "
                         "between frame dispatches, with pipelined dispatch "
                         "at --depth (see SlamSystem._mapping_steps)")
    ap.add_argument("--depth", type=int, default=1,
                    help="pipeline depth with --coop (1 = commit each frame "
                         "before the next dispatch, sync-identical gates; "
                         "3 = deepest overlap, keyframe decisions land late)")
    ap.add_argument("--pipelined", action="store_true",
                    help="optimistic lag-1 dispatch: per-frame gates resolve "
                         "one frame late")
    ap.add_argument("--localization-after", type=int, default=0,
                    help="switch to localization-only mode (no mapping) after "
                         "N frames (0 = never; viewer menu toggle in the "
                         "reference, System.cc:311-319)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU, cuda)")
    ap.add_argument("--overlay-every", type=int, default=0,
                    help="save a FrameDrawer-style keypoint/status overlay "
                         "every N frames (FrameDrawer.cc:38-120; needs matplotlib)")
    ap.add_argument("--overlay-dir", default="overlays",
                    help="directory for --overlay-every artifacts")
    args = ap.parse_args(argv)

    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("run_dataset: CUDA is not available; pass --cpu to run on the CPU")
    cfg = _config(args)
    slam = SlamSystem(cfg, device=device, async_mapping=args.async_mapping,
                      pipelined=args.pipelined or args.coop,
                      pipeline_depth=args.depth if args.coop else 1,
                      cooperative_mapping=args.coop)
    seq = _sequence(args, cfg)

    times = track_frames(slam, seq, max_frames=args.max_frames,
                         localization_after=args.localization_after,
                         overlay_every=args.overlay_every, overlay_dir=args.overlay_dir)
    n = len(times)

    slam.shutdown()
    times_s = np.sort(np.asarray(times))
    print("-------")
    print(f"frames processed: {n}")
    if n:
        print(f"median tracking time: {np.median(times_s) * 1e3:.2f} ms")
        print(f"mean tracking time:   {np.mean(times_s) * 1e3:.2f} ms")
        print(f"throughput:           {1.0 / np.mean(times_s):.1f} fps")
    slam.export_trajectory_tum(args.out)
    print(f"trajectory saved to {args.out}")
    if "kitti" in args.mode:
        kitti_out = os.path.splitext(args.out)[0] + ".kitti.txt"
        slam.export_trajectory_kitti(kitti_out)
        print(f"KITTI-format trajectory saved to {kitti_out}")
    if args.out_kf:
        slam.export_keyframe_trajectory_tum(args.out_kf)
        print(f"keyframe trajectory saved to {args.out_kf}")
    summary = {
        "mode": args.mode, "frames": n,
        "median_track_ms": float(np.median(times_s) * 1e3) if n else None,
        "fps": float(1.0 / np.mean(times_s)) if n else None,
    }
    print(json.dumps(summary))
    return dict(summary, mean_track_ms=float(np.mean(times_s) * 1e3) if n else None,
                n_kf=slam.n_kf, n_pt=slam.n_pt)


if __name__ == "__main__":
    main()
