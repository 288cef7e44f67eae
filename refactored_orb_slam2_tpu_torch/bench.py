"""Benchmark: full-system per-frame tracking throughput on one GPU (port of
bench.py).

    python -m refactored_orb_slam2_tpu_torch.bench

Drives the port's whole ``SlamSystem`` tracking path end to end — frame
build (ORB pyramid/FAST/rBRIEF + RGB-D stereo synthesis), motion-model
projection matching, pose-only LM, local-map selection + matching (the
window CUDA kernel), second pose opt, visibility statistics, keyframe
decision — plus keyframe-rate mapping (triangulation and fusion through the
masked CUDA kernel, culling, local BA) inside the frames that insert a
keyframe, at the reference's TUM configuration (640x480, 1000 features, 8
levels, map 512 keyframes x 65536 points x 32 observations).

Scene: the raycast room world (utils/world3d.scene_room(seed=11)), a
TUM-fr1/desk analog, orbited at handheld speed
(``traj_room_orbit(160, seed=5, span=0.45*pi)``, noise 2.0), rendered on
the card before timing, so the frames enter through
``track_rgbd_device`` as a sensor's DMA would put them there.  A 30-frame
pre-roll over a faster orbit (seed 7, span 0.9*pi) runs every tracking and
mapping step once before ``reset()``.

The system runs in the JAX bench's mode (``BENCH_MODE``, bench.py:66-67):
each tracked frame is one CUDA graph replay, dispatched optimistically
three frames ahead of its commit (pipelined, depth 3), and local mapping
advances as bounded steps pumped between the frame dispatches on the
tracking thread (cooperative).  Mapping time is the host clock around
``_pump_mapping``, as the JAX bench takes it.  Before timing, each CUDA
kernel is held once against its plain version at the path's shapes.  Each
pass tracks the 160 frames on a fresh map and asserts 0 lost, 4 <= n_kf <=
64 and mapping drained; the frames after frame 19 are timed on the host
clock, each call as the caller waits for it (a pipelined call returns once
its frame is dispatched and the frame three back committed; the final
flush counts to the last frame).  The headline is the median of the
per-pass medians, with their spread.

Prints ONE JSON line (the JAX bench's keys, plus ``device``: the card's name
and power limit from nvidia-smi).  Baseline: the reference runs at the
dataset rate (TUM 30 fps), so ``vs_baseline = fps / 30``.  Without CUDA it
exits non-zero: a CPU time is no yardstick.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 160
WARM_UP = 19          # frames up to this one are not timed (cadence settling)
#: the JAX bench's SlamSystem mode (bench.py:66-67)
BENCH_MODE = dict(cooperative_mapping=True, pipelined=True, pipeline_depth=3)


def bench_config():
    """640x480 RGB-D, TUM fr1 intrinsics, bf 40, 1000 features, 8 levels,
    map 512 x 65536 x 32."""
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    return SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0,
                            width=640, height=480, fps=30),
        orb=ORBConfig(n_features=1000, n_levels=8),
        map=MapConfig(max_keyframes=512, max_points=65536, max_obs_per_point=32),
    )


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_selfcheck(cfg, device="cuda") -> None:
    """Each CUDA kernel once against its plain version on ``device``:
    ``window_match`` at the tracking shape (4096 local points x the
    configuration's features), ``hamming_best2`` at mapping's fuse shape
    (2048 projected points x the features, window and octave-band mask).
    Raises on any difference.  The launch counts are put back: these are
    comparisons, not the path's launches."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.ops import matching as M

    g = torch.Generator(device="cpu").manual_seed(0)
    w, h = cfg.camera.width, cfg.camera.height
    n_feat, n_lv = cfg.orb.n_features, cfg.orb.n_levels

    def words(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=g, dtype=torch.int64) \
            .to(torch.int32).to(device)

    def uv(n):
        return (torch.rand((n, 2), generator=g) * torch.tensor([w, h])).to(device)

    def octaves(n):
        return torch.randint(0, n_lv, (n,), generator=g, dtype=torch.int32).to(device)

    saved = dict(cuda_hamming.launches)
    try:
        n1 = 4096
        args = (words(n1), words(n_feat), uv(n1), uv(n_feat),
                (4.0 + 16.0 * torch.rand(n1, generator=g)).to(device),
                octaves(n1), octaves(n_feat),
                (torch.rand(n1, generator=g) < 0.9).to(device),
                (torch.rand(n_feat, generator=g) < 0.9).to(device))
        got = cuda_hamming.window_match(*args, (-1, 0))
        ref = cuda_hamming.window_match_reference(*args, (-1, 0))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"window_match differs from its plain version at {n1}x{n_feat}")
        n1 = 2048
        uv_a, uv_b, oct_a, oct_b = uv(n1), uv(n_feat), octaves(n1), octaves(n_feat)
        radius = (3.0 * 1.2 ** oct_a.float()) * 8.0
        mask = M.window_mask(uv_a, uv_b, radius) & M.octave_band_mask(oct_a, oct_b, -1, 1)
        args = (words(n1), words(n_feat), mask)
        got = cuda_hamming.hamming_best2(*args)
        ref = cuda_hamming.hamming_best2_reference(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"hamming_best2 differs from its plain version at {n1}x{n_feat}")
    finally:
        cuda_hamming.launches.update(saved)


def run_pass(slam, frames, tag, map_acc: dict) -> tuple[float, float]:
    """One timed pass over ``frames`` ((image, depth) in the wire encoding
    on the system's device) on a fresh map; returns the median and mean
    time in seconds of the frames after the warm-up boundary, each call as
    its caller waits for it (a pipelined call waits for the commit of the
    frame ``pipeline_depth`` back, not for its own).  Raises if a frame was
    lost, the keyframe count is implausible or mapping did not drain."""
    slam.reset()
    map_acc["t"] = 0.0
    times, n_lost, n_kf0, warm_start = [], 0, 0, 0
    for i, (img, depth) in enumerate(frames):
        t0 = time.perf_counter()
        pose = slam.track_rgbd_device(img, depth, i / 30.0)
        times.append(time.perf_counter() - t0)
        if pose is None:
            n_lost += 1
        if i == WARM_UP:
            warm_start = len(times)
            n_kf0 = slam.n_kf
            map_acc["t"] = 0.0
    t0 = time.perf_counter()
    slam.flush_pipeline()
    times[-1] += time.perf_counter() - t0
    n_kf_end = slam.n_kf
    if not slam.wait_mapping_idle(timeout=60):
        raise RuntimeError(f"pass {tag}: mapping failed to drain")
    # a pipelined frame can be lost at its commit, after its call returned
    n_lost += sum(log.lost for log in slam.trajectory)
    if n_lost:
        raise RuntimeError(f"pass {tag}: tracking lost {n_lost} frames")
    if not 4 <= n_kf_end <= 64:
        raise RuntimeError(f"pass {tag}: implausible keyframe count {n_kf_end} "
                           "(mapping silently skipped or cadence broken)")
    n_kf = n_kf_end - n_kf0
    timed = np.asarray(times[warm_start:])
    med, mean = float(np.median(timed)), float(timed.mean())
    print(f"  pass {tag}: frames={len(timed)} lost={n_lost} kf={n_kf_end} "
          f"pts={slam.n_pt} median={med * 1e3:.2f}ms mean={mean * 1e3:.2f}ms "
          f"mapping={map_acc['t'] / max(n_kf, 1) * 1e3:.1f}ms/kf",
          file=sys.stderr, flush=True)
    return med, mean


def summarize(results, device: str) -> dict:
    """The JSON line from the per-pass (median, mean) pairs."""
    meds = sorted(r[0] for r in results)
    means = sorted(r[1] for r in results)
    med, mean = meds[len(meds) // 2], means[len(means) // 2]
    spread_pct = (meds[-1] - meds[0]) / med * 100.0
    fps = 1.0 / med
    return {
        "metric": "system_tracking_fps",
        "value": round(fps, 2),
        "unit": f"frames/s median (median of {len(results)} "
                f"pass{'es' if len(results) != 1 else ''}), full "
                "SlamSystem tracking (640x480 RGB-D, 1000 feats, 64k-point map, "
                "device-resident frames, pipeline depth 3, cooperative mapping)",
        "vs_baseline": round(fps / 30.0, 3),
        "median_ms": round(med * 1e3, 2),
        "mean_ms": round(mean * 1e3, 2),
        "mean_fps": round(1.0 / mean, 2),
        "median_spread_pct": round(spread_pct, 1),
        "device": device,
    }


def main(passes: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available; the bench times the port on "
                         "a GPU and has no CPU mode")
    from refactored_orb_slam2_tpu_torch.system import SlamSystem
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    device = card()
    cfg = bench_config()
    slam = SlamSystem(cfg, device="cuda", **BENCH_MODE)
    kernel_selfcheck(cfg)

    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(N_FRAMES, seed=5, span=0.45 * np.pi)
    rng = np.random.default_rng(0)
    print("rendering frames (device-resident)...", file=sys.stderr, flush=True)
    frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                  device="cuda") for T in poses]
    torch.cuda.synchronize()

    # pre-roll: a faster orbit (denser keyframes) runs every tracking and
    # mapping step once (and captures the frame's CUDA graph) before the
    # timed passes
    print("rendered; pre-roll...", file=sys.stderr, flush=True)
    for i, T in enumerate(W.traj_room_orbit(30, seed=7, span=0.9 * np.pi)):
        img, depth = world.render_device(T, slam.cam, want_depth=True, noise=2.0, rng=rng,
                                         device="cuda")
        slam.track_rgbd_device(img, depth, i / 30.0)
    slam.flush_pipeline()
    slam.reset()
    print("pre-roll done; tracking...", file=sys.stderr, flush=True)

    # mapping runs where it is pumped, between frame dispatches (host clock,
    # as the JAX bench takes it)
    map_acc = {"t": 0.0}
    pump = slam._pump_mapping

    def timed_pump(budget=1):
        t0 = time.perf_counter()
        pump(budget)
        map_acc["t"] += time.perf_counter() - t0

    slam._pump_mapping = timed_pump
    results = [run_pass(slam, frames, k + 1, map_acc) for k in range(passes)]
    out = summarize(results, device)
    print(f"median-of-{passes}: {out['median_ms']:.2f}ms (spread "
          f"{out['median_spread_pct']:.1f}%) mean-of-{passes}: {out['mean_ms']:.2f}ms "
          f"({device})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
