"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device — requires CUDA (there is no CPU path) and prints the card's name
   and power limit from nvidia-smi;
2. build — compiles the window-match kernel from
   refactored_orb_slam2_tpu_torch/csrc/window_match.cu (sm_90a, nvcc) into
   the ignored build directory, timed as set-up;
3. kernel — the kernel against its plain PyTorch version on the card at the
   JAX self-check shape (512 x 1024), the golden shape (256 x 384) and the
   tracking shape (4096 local points x 1000 features): d1, i1 and d2 equal,
   the ratio gate equal at 0.7 and 0.9; then the median time of each at the
   tracking shape from CUDA events, interleaved;
4. slice — SlamSystem(device="cuda") at the bench configuration (640x480
   RGB-D, 1000 ORB features, 8 levels, map 512 keyframes x 65536 points x
   32 observations) tracks the first 14 frames of the bench trajectory,
   rendered on the card; asserts 14/14 tracked, one keyframe, ATE against
   the rendered trajectory < 2 mm, and at least one kernel launch per fused
   step; prints the median per-frame time over frames 2-13;
5. breakdown — where a frame's time goes, on a second system tracking the
   same frames after the checked run: stage times with a synchronize around
   each stage (frames 4-7), a torch.profiler trace (frames 8-10: device
   busy time, kernel launches, host API calls) and the host
   synchronizations flagged by CUDA sync-debug mode (frames 11-13).

The second-to-last line is the kernel JSON, the last line the device JSON.
"""

import collections
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, events) -> float:
    times = []
    for _ in range(reps):
        start, end = events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernel_case(rng, n1, n2, radius_range, band, p_valid):
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    dev = "cuda"
    words = lambda n: rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (
        t(words(n1)), t(words(n2)),
        t(rng.uniform(0, 640, (n1, 2)).astype(np.float32)),
        t(rng.uniform(0, 640, (n2, 2)).astype(np.float32)),
        t(rng.uniform(*radius_range, n1).astype(np.float32)),
        t(rng.integers(0, 8, n1).astype(np.int32)),
        t(rng.integers(0, 8, n2).astype(np.int32)),
        t(rng.random(n1) < p_valid), t(rng.random(n2) < p_valid),
    )
    d1, i1, d2 = cuda_hamming.window_match(*args, band)
    r1, ri, r2 = cuda_hamming.window_match_reference(*args, band)
    torch.cuda.synchronize()
    if not (torch.equal(d1, r1) and torch.equal(d2, r2) and torch.equal(i1, ri)):
        raise AssertionError(f"kernel disagrees with its plain version at {n1}x{n2}")
    for ratio in (0.7, 0.9):
        gk = (d1 <= 256) & (d1.float() < ratio * d2.float())
        gr = (r1 <= 256) & (r1.float() < ratio * r2.float())
        if not torch.equal(gk, gr):
            raise AssertionError(f"ratio gate {ratio} differs at {n1}x{n2}")
    err = max(int((d1 - r1).abs().max()), int((d2 - r2).abs().max()),
              int((i1 - ri).abs().max()))
    print(f"kernel {n1}x{n2} band {band}: equal (max_abs_err {err}, "
          f"{int((r1 < (1 << 20)).sum())} rows with a candidate)")
    return args, err


_STAGES = (  # (module or class, attribute, label); optimize_pose runs twice
    ("system.SlamSystem", "_build_frame", "frame build (ORB + depth)"),
    ("system.TK", "match_motion_model", "motion-model match (2 windows)"),
    ("system", "optimize_pose", "pose-only LM (2 calls)"),
    ("system.TK", "select_local_points", "select local points"),
    ("system.TK", "match_local_points", "match local points (kernel inside)"),
)


@contextlib.contextmanager
def _stage_timers(totals: dict):
    """Wrap the fused step's stages with a synchronize on each side and add
    each call's host-clock time to ``totals[label]``; restore on exit."""
    from refactored_orb_slam2_tpu_torch import system

    def owner(path):
        obj = system
        for part in path.split(".")[1:]:
            obj = getattr(obj, part)
        return obj

    def timed(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[label] = totals.get(label, 0.0) + time.perf_counter() - t0
            return out
        return run

    saved = [(owner(path), name, getattr(owner(path), name))
             for path, name, _ in _STAGES]
    for (obj, name, fn), (_, _, label) in zip(saved, _STAGES):
        setattr(obj, name, timed(fn, label))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _busy_us(events) -> float:
    """Length of the union of the device events' time ranges, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _breakdown(slam, frames, frame_ms: float, card: str) -> None:
    """Phase 5 on a fresh system over the same frames: frames 0-3 warm up,
    4-7 are stage-timed, 8-10 traced, 11-13 run under sync-debug mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    track = lambda i: slam.track_rgbd_device(frames[i][0], frames[i][1], i / 30.0)
    for i in range(4):
        track(i)
    torch.cuda.synchronize()

    totals, n, whole = {}, 4, "whole frame, stages synchronized"
    with _stage_timers(totals):
        for i in range(4, 4 + n):
            t0 = time.perf_counter()
            track(i)
            torch.cuda.synchronize()
            totals[whole] = totals.get(whole, 0.0) + time.perf_counter() - t0
    for label, t in totals.items():
        print(f"stage {label}: {t / n * 1e3:.2f} ms/frame (frames 4-7; {card})")

    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(8, 8 + n):
            track(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if dev:
        busy_ms = _busy_us(dev) / 1e3
        print(f"trace, frames 8-10: {len(dev) / n:.0f} device events/frame, "
              f"device busy {busy_ms / n:.2f} ms/frame, traced wall "
              f"{wall_ms / n:.2f} ms/frame, busy share in the trace "
              f"{busy_ms / wall_ms:.4f} (tracing slows the host); device busy / "
              f"untraced median frame of phase 4 {busy_ms / n / frame_ms:.4f} "
              f"(cross-run estimate; {card})")
    else:
        print(f"trace, frames 8-10: traced wall {wall_ms / n:.2f} ms/frame; "
              "device busy not measured (the trace holds no device events)")
    api = sorted((e for e in prof.key_averages() if e.key.startswith("cuda")),
                 key=lambda e: -e.count)
    for e in api[:6]:
        print(f"trace api {e.key}: {e.count / n:.0f} calls/frame, "
              f"{e.cpu_time_total / n / 1e3:.2f} ms/frame host")

    n = 3
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(11, 11 + n):
                track(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message)
    )
    print(f"host syncs, frames 11-13: {sum(sites.values()) / n:.1f} per frame at "
          + (", ".join(f"{k} x{v}" for k, v in sorted(sites.items())) or "none"))
    if slam.n_kf != 1 or len(slam.tracked_logs()) != len(frames):
        raise AssertionError("the breakdown run did not track every frame")


def main() -> None:
    # ---- 1. device
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; the port runs only on a GPU")
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}")

    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.system import SlamSystem
    from refactored_orb_slam2_tpu_torch.utils import world3d as W
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = cuda_hamming.build()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s (set-up)")

    # ---- 3. kernel against its plain version
    rng = np.random.default_rng(1)
    _kernel_case(rng, 512, 1024, (60.0, 60.0), (-1, 0), 1.0)       # self-check
    _kernel_case(rng, 256, 384, (30.0, 120.0), (-1, 1), 0.9)       # golden
    args, err = _kernel_case(rng, 4096, 1000, (4.0, 20.0), (-1, 0), 0.9)
    events = lambda: (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
    kern = lambda: cuda_hamming.window_match(*args, (-1, 0))
    plain = lambda: cuda_hamming.window_match_reference(*args, (-1, 0))
    for _ in range(3):
        kern()
        plain()
    ms_k, ms_p = [], []
    for i in range(20):   # interleaved: plain, kernel, kernel, plain, ...
        order = (plain, kern) if i % 2 == 0 else (kern, plain)
        for fn in order:
            (ms_p if fn is plain else ms_k).append(_median_ms(fn, 1, events))
    ms, plain_ms = float(np.median(ms_k)), float(np.median(ms_p))
    print(f"kernel time at 4096x1000: window_match {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 20 each, CUDA events; {card})")

    # ---- 4. the slice
    H, Wd = 480, 640
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0,
                            width=Wd, height=H, fps=30),
        orb=ORBConfig(n_features=1000, n_levels=8),
        map=MapConfig(max_keyframes=512, max_points=65536, max_obs_per_point=32),
    )
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, device="cuda")
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:14]
    frng = np.random.default_rng(0)
    frames = [world.render_device(T, slam.cam, want_depth=True, noise=2.0,
                                  rng=frng, device="cuda") for T in poses]
    torch.cuda.synchronize()
    print(f"slice set-up: system + 14 rendered frames in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    cuda_hamming.reset_launches()
    times, out = [], []
    for i, (img, depth) in enumerate(frames):
        t0 = time.perf_counter()
        pose = slam.track_rgbd_device(img, depth, i / 30.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append(pose)
    launches = cuda_hamming.launches
    torch.cuda.synchronize()

    n_tracked = sum(p is not None for p in out)
    est = slam.frame_poses()
    if n_tracked != 14 or est.shape != (14, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"tracked {n_tracked}/14 frames, poses {est.shape}")
    if slam.n_kf != 1:
        raise AssertionError(f"n_kf = {slam.n_kf}, expected 1")
    if launches < 13:
        raise AssertionError(f"window_match launched {launches} times in 13 fused steps")
    # ATE of the camera centres, in the first camera's frame
    centres = slam.camera_centers()
    gt = np.stack([(poses[0] @ np.linalg.inv(T))[:3, 3] for T in poses])
    ate = float(np.sqrt(np.mean(np.sum((centres - gt) ** 2, axis=1))))
    if not ate < 0.002:
        raise AssertionError(f"ATE {ate:.6f} m >= 0.002 m")
    med = float(np.median(times[2:])) * 1e3
    print(f"slice: 14/14 tracked, n_kf {slam.n_kf}, n_pt {slam.n_pt}, "
          f"ATE {ate:.6f} m, window_match launches {launches}")
    print(f"slice per-frame time, frames 2-13: median {med:.2f} ms, "
          f"min {min(times[2:]) * 1e3:.2f} ms, max {max(times[2:]) * 1e3:.2f} ms "
          f"(host clock with synchronize; {card})")
    print("per-frame ms: " + " ".join(f"{t * 1e3:.2f}" for t in times))
    print(f"slice peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # ---- 5. where the time goes
    _breakdown(SlamSystem(cfg, device="cuda"), frames, med, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [{
        "name": "window_match",
        "route": "cuda",
        "source": "refactored_orb_slam2_tpu_torch/csrc/window_match.cu",
        "replaces": "refactored_orb_slam2_tpu/ops/pallas_hamming.py:193",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
