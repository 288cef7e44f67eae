"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --circuit-only | --io-only]

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device — requires CUDA (there is no CPU path) and prints the card's name
   and power limit from nvidia-smi;
2. build — compiles both Hamming kernels from
   refactored_orb_slam2_tpu_torch/csrc/ (window_match.cu, masked_best2.cu;
   sm_90a, one nvcc per source, started together) into the ignored build
   directory, timed as set-up;
3. kernels — each kernel against its plain PyTorch version on the card,
   d1, i1 and d2 equal.  The window matcher at the JAX self-check shape
   (512 x 1024), the golden shape (256 x 384) and the tracking shape (4096
   local points x 1000 features), with the ratio gate equal at 0.7 and 0.9.
   The masked matcher at the fuse shape (2048 candidates x 1000 features,
   window and octave-band mask), the triangulation shape (1000 x 1000, a
   band like an epipolar one), the stereo shape (1200 left x 1200 right
   features under the row, disparity and octave-band mask of
   stereo_match), a random 30%-dense mask (1000 x 1500), a ragged
   777 x 1031 case with all-false rows and duplicated descriptors, and the
   relocalization rescue shape (1000 x 1000 keyframe slots x frame
   features, window 10 x scale px, octave band +-1; 1200 x 1200 for the
   stereo preset), and loop closing's two on the circuit's camera: the
   fuse (1024 candidates x 1000 slots, window 4 x scale px, band +-1) and
   the projection count (2048 x 1000, 10 px, no band).
   Then both at the shapes wide loads and persistent grids can get wrong:
   column counts off every alignment, one row, one column, 20000 rows,
   6000 to 20000 columns, nothing to match, strided, transposed and
   odd-offset views.  Then the times at the tracking shape and at the fuse,
   triangulation, stereo, rescue and loop shapes: the kernel's own duration on the device (from
   a torch.profiler trace, median of 20 launches), the same at N1 = N2 = 1
   (what any launch costs), the bound computed from the inputs (bytes over
   the memory rate or operations over the non-tensor rate, whichever is
   larger) with the kernel's share of it, and CUDA-event medians around the
   wrapper and the plain version, interleaved (what a caller waits);
4. RGB-D sequence — SlamSystem(device="cuda") at the bench configuration (640x480
   RGB-D, TUM fr1 intrinsics, 1000 ORB features, 8 levels, map 512
   keyframes x 65536 points x 32 observations), synchronous mapping, loop
   closing on (the default), tracks all 160 frames of the bench room-orbit trajectory,
   rendered on the card.  Asserts no frame lost, n_kf >= 3, a local BA and
   a triangulation that created points, a window-kernel launch per tracked
   frame and a masked-kernel launch per keyframe after the first, no
   keyframe reaching loop detection (7 keyframes, under kf_gap + 2), and the
   ATE bound ATE_BOUND_M taken from the JAX package's run of the same
   frames; prints n_kf, n_pt, the culled keyframes, the ATE, the median
   frame time with and without keyframe frames and the mapping time per
   keyframe;
5. breakdown — where the time goes, on a second system tracking the same
   frames after the checked run: stage times with a synchronize around
   each stage (frames 4-7), a torch.profiler trace (frames 8-10: device
   busy time, kernel launches, host API calls) and the host
   synchronizations flagged by CUDA sync-debug mode (frames 11-13); then
   for every keyframe the synchronized times of the mapping steps, the host
   synchronizations of its insertion and mapping, and a trace of one
   keyframe's mapping;
6. localization-only — on the RGB-D system of phase 4 after its 160 frames:
   activate_localization_mode, then the last 40 frames again in reverse
   order.  Asserts every frame tracked and n_kf, n_pt unchanged; prints the
   host synchronizations of a localization-only frame (the decomposed
   path) beside the fused path's, and the median frame time;
7. stereo sequence — the port's stereo_euroc preset (752x480, 1200 features,
   8 levels, bf 47.906, map 512 x 65536 x 32), the same room orbit rendered
   as stereo pairs on the card, through track_stereo_device.  Asserts no
   frame lost, n_kf >= 3, a window launch per tracked frame, one masked
   launch per frame from stereo_match (counted apart from mapping's), a
   masked launch per mapped keyframe, and the ATE bound STEREO_ATE_BOUND_M
   from the JAX package's run of the same frames;
8. monocular sequence — the bench camera without depth (640x480, TUM fr1
   intrinsics, bf 0, 1000 features, 8 levels), through
   track_monocular_device.  Asserts that the two-view initializer succeeds
   and prints the frame, at least 90% of the frames after it tracked,
   points triangulated at every mapped keyframe, loop detection at the
   keyframes from the 12th on and no loop closed (as the JAX package's run,
   JAX_LOOP_DETECTION), and the Sim3-aligned ATE bound MONO_ATE_BOUND_M
   from the JAX package's run; prints the host synchronizations of the
   accepted initialization attempt and loop closing's time per keyframe;
9. relocalization — on the RGB-D system after phase 6 (localization mode
   off), then on it again in localization-only mode, on the stereo system
   after phase 7 and on the monocular one after phase 8: two uniform grey
   frames (the second a relocalization attempt with no feature), then orbit
   frames 80-83 again (120-123 in localization-only mode), already rendered.
   Asserts LOST after the grey frames, the relocalization at the orbit frame
   where the JAX package's happened, its camera centre within
   RELOC_BOUND_M of the rendered one, the three frames after it tracked, a
   window_match launch on the relocalization frame, the map unchanged in
   localization-only mode; the monocular path only prints where the JAX
   package does not relocalize.  hamming_best2 is held against its plain
   version on the rescue search's own tensors at the accepted pose.  Prints
   the relocalization frame's time and host syncs (sync-debug mode), each
   candidate's SearchByBoW matches, EPnP and pose-LM inliers and rescue
   rounds, the launches and the peak device memory;
10. loop closure — the stereo street circuit of tests/test_loop_e2e.py
   (scene_street(seed=41, block=22, road_w=8), 140 frames of
   traj_street_loop over 1.27 laps, 320x240, bf 120, 1000 features, 4
   levels), rendered on the card with the true focal and tracked with one
   4 px larger, on the card's map (512 x 65536 x 32) with loop closing on.
   Asserts at most 2 frames lost, one loop edge whose keyframes were made
   within CIRCUIT_FRAME_TOL frames of the JAX run's pair, a global BA and
   the rigidly aligned ATE under 1% of the path and under
   CIRCUIT_ATE_BOUND_M; prints the synchronized times of detection,
   compute_sim3, the projection count, _correct_loop in four spans and the
   global BA, the loop keyframe's host syncs and launches, the run's
   launches and its peak device memory.
11. I/O and the drivers — on the RGB-D system after phase 9 (in
   --io-only mode, after phase 4), at the card's map (512 x 65536 x 32):
   save_map into a temporary directory (its time and the file's size);
   load_map into a fresh SlamSystem(device="cuda"), every MapState field,
   the vocabulary and the KeyFrameDB banks torch.equal and the counters and
   culled chain equal (its time); the loaded system set LOST (the JAX
   loader leaves a fresh system NOT_INITIALIZED, a fault of the reference)
   and in localization-only mode relocalizes at orbit frame 120 within
   RELOC_BOUND_M["localization"], tracks 121-123 with the map unchanged and
   a window_match launch on the relocalization frame; then, mapping again,
   tracks 124-159 with none lost and prints the keyframes it added.  Then
   the dataset driver's loop (scripts/run_dataset.py::track_frames) over
   host copies of all 160 frames on a fresh system through track_rgbd, the
   TUM, KITTI and keyframe exports and a ground-truth TUM file, and
   scripts/evaluate.py (a subprocess) on the pair: ATE under ATE_BOUND_M;
   its median frame beside phase 4's device-entry one.  Last, one pass of
   the port's bench (refactored_orb_slam2_tpu_torch/bench.py), its JSON
   line printed.  Both kernels must launch on this path ("io").

Phases 7 and 8 also print the synchronized stage times of a tracked frame
on a second system (frames 4-7 after the first tracked one).  Every path is
driven with the kernels' launch counts set to 0 just before it and read
just after ("relocalization" sums phase 9's four episodes, "loop" is
phase 10, "io" phase 11 from its relocalization on).
``tests/test_torch_smoke_reference.py`` (marked slow) runs the JAX package
on the CPU over the same frames (phase 10: the circuit's) and holds the
JAX_* constants below to what it gives.

The line before the last is the card's name and power limit, the one
before it the kernel JSON; the last line is the device JSON.
"""

import collections
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_FRAMES = 160
# The JAX package on the CPU, synchronous mode, loop closing off, on these
# 160 frames (its own renderer, which agrees with the port's): lost 0,
# n_kf 7, n_pt 2301, ATE 0.0034087 m.  The bound is twice that ATE: the
# card's float order and renderer move every pose a little, not the
# keyframe decisions.
JAX_ATE_M = 0.0034087
ATE_BOUND_M = 2 * JAX_ATE_M
# The same for the stereo and the monocular sequence: JAX on the CPU over
# the frames of the port's renderer on the CPU, as
# tests/test_torch_smoke_reference.py runs it.  Stereo: lost 0, n_kf 8 at
# frames 0, 21, 28, 38, 52, 68, 92, 109, n_pt 2359, ATE 0.0021103 m; the
# bound is twice that, as for RGB-D.
JAX_STEREO_ATE_M = 0.0021103
STEREO_ATE_BOUND_M = 2 * JAX_STEREO_ATE_M
# Monocular (Sim3-aligned): lost 0 from frame 2 on, n_kf 158, n_pt 23586, ATE
# 0.0009541 m.  The bound is three times that: the port draws other minimal
# sets than jax.random gives, so its initial map and scale are another draw.
JAX_MONO_ATE_M = 0.0009541
MONO_ATE_BOUND_M = 3 * JAX_MONO_ATE_M
N_LOCALIZATION = 40
# Phase 9, JAX on the CPU over the same frames (the test above): the orbit
# frame that relocalized and its camera centre's distance from the rendered
# one (monocular: after the Sim3 alignment of the tracked run), per path
# (None where JAX does not relocalize).  JAX on the CPU relocalized on every
# path at the first orbit frame, with 0 reloc_rejects, and tracked the
# three after it; RGB-D and stereo inserted no keyframe, monocular 4.  Each
# bound is three times that distance, never more than 5 cm
# (tests/test_tracking_robustness.py): the port draws other EPnP sets than
# jax.random gives.
JAX_RELOC = {"rgbd": (80, 0.0049111), "localization": (120, 0.0017492),
             "stereo": (80, 0.0012558), "monocular": (80, 0.0014613)}
RELOC_BOUND_M = {path: min(3 * err, 0.05) for path, (_, err) in JAX_RELOC.items()}
# Loop closing is on in every phase, as the facade's default.  The JAX
# package on the CPU over phases 4, 7 and 8 (the test above): keyframes
# that reached loop detection (n_kf >= kf_gap + 2) and the loops closed
# (loop keyframe, current keyframe, frame).  Monocular detects at every
# keyframe from the 12th on and closes no loop on the room orbit, so its
# ATE is the one above.
JAX_LOOP_DETECTION = {"rgbd": (0, []), "stereo": (0, []), "monocular": (147, [])}
# Phase 10, the street circuit: frames, block and road width of the
# JAX package's loop test, its rendering focal and the tracker's offset.
CIRCUIT_FRAMES, CIRCUIT_BLOCK, CIRCUIT_ROAD_W = 140, 22.0, 8.0
CIRCUIT_F, CIRCUIT_DF = 320.0, 4.0
# The JAX package on the CPU over the circuit's frames (the port's renderer)
# at the card's map capacity: lost 0, n_kf 98, n_pt 19105, the loop closed
# at frame 124 between keyframes 5 and 88, made at frames 6 and 124, one
# global BA, rigidly aligned ATE 0.2420207 m over the 127.33 m path.  The
# card's run decides a keyframe here and there otherwise (another float
# order), which shifts keyframe slots, so the loop edge is held to the JAX
# pair by the frames its two keyframes were made at, within
# CIRCUIT_FRAME_TOL frames.  The ATE bound is twice the JAX run's, as for
# phases 4 and 7, and the test's 1% of the path.
JAX_CIRCUIT = {"lost": 0, "loop": (5, 88), "loop_frames": (6, 124), "frame": 124,
               "gba_runs": 1, "ate": 0.2420207}
CIRCUIT_FRAME_TOL = 3
CIRCUIT_ATE_BOUND_M = 2 * JAX_CIRCUIT["ate"]


def rgbd_config():
    """The bench configuration: 640x480 RGB-D, TUM fr1 intrinsics."""
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


def stereo_config():
    """The port's stereo_euroc preset: 752x480, 1200 features, bf 47.906."""
    from refactored_orb_slam2_tpu_torch.utils.presets import get_preset

    return get_preset("stereo_euroc")


def mono_config():
    """The bench camera without depth."""
    import dataclasses

    cfg = rgbd_config()
    return cfg.replace(sensor="monocular",
                       camera=dataclasses.replace(cfg.camera, bf=0.0))


def circuit_config():
    """Phase 10: the stereo street circuit of tests/test_loop_e2e.py (320x240,
    bf 120, 1000 features, 4 levels, fuse and triangulation over 4
    neighbours), tracked with a focal CIRCUIT_DF px above the rendering
    camera's, on the card's map (512 x 65536 x 32) and with loop closing at
    its default, on."""
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    f = CIRCUIT_F + CIRCUIT_DF
    return SystemConfig(
        sensor="stereo",
        camera=CameraConfig(fx=f, fy=f, cx=160.0, cy=120.0, bf=120.0, width=320, height=240,
                            fps=10),
        orb=ORBConfig(n_features=1000, n_levels=4),
        map=MapConfig(max_keyframes=512, max_points=65536, max_obs_per_point=32,
                      fuse_neighbors=4, triangulate_neighbors=4),
    )


def circuit_poses() -> np.ndarray:
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    return W.traj_street_loop(CIRCUIT_FRAMES, block=CIRCUIT_BLOCK, road_w=CIRCUIT_ROAD_W,
                              seed=41, laps=CIRCUIT_FRAMES / 110.0)


def render_circuit(poses, device) -> list:
    """The circuit's stereo pairs in the wire encoding on ``device``,
    rendered with the true focal (one noise generator, in order)."""
    import dataclasses

    from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    cfg = circuit_config()
    cam = camera_from_config(dataclasses.replace(cfg.camera, fx=CIRCUIT_F, fy=CIRCUIT_F))
    world, rng = W.scene_street(seed=41, block=CIRCUIT_BLOCK, road_w=CIRCUIT_ROAD_W), \
        np.random.default_rng(6)
    return [world.render_stereo_device(T, cam, noise=2.0, rng=rng, device=device) for T in poses]


def world_centres(poses) -> np.ndarray:
    """Camera centres of the rendered trajectory in the world frame."""
    return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])


def ate_rmse_se3(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE after a rigid (Umeyama, no scale) alignment, as the JAX
    package's utils/synthetic.ate_rmse measures it."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(G.T @ E / len(E))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    return ate_rmse(E @ (U @ S @ Vt).T + mu_g, gt)


def smoke_poses() -> np.ndarray:
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    return W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:N_FRAMES]


def render_frames(cfg, poses, device) -> list:
    """One tuple per pose in the wire encoding on ``device``, as the
    sensor's ``track_*_device`` takes it: (image, depth), (left, right) or
    (image,).  One noise generator serves the whole sequence in order."""
    from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
    from refactored_orb_slam2_tpu_torch.utils import world3d as W

    world, rng, cam = W.scene_room(seed=11), np.random.default_rng(0), camera_from_config(cfg.camera)
    if cfg.sensor == "rgbd":
        return [world.render_device(T, cam, want_depth=True, noise=2.0, rng=rng,
                                    device=device) for T in poses]
    if cfg.sensor == "stereo":
        return [world.render_stereo_device(T, cam, noise=2.0, rng=rng, device=device)
                for T in poses]
    return [(world.render_device(T, cam, noise=2.0, rng=rng, device=device),)
            for T in poses]


def track_device(slam, frame: tuple, i: int):
    """Frame i through the sensor's device entry point."""
    entry = {"rgbd": slam.track_rgbd_device, "stereo": slam.track_stereo_device,
             "monocular": slam.track_monocular_device}[slam.sensor]
    return entry(*frame, i / slam.cfg.camera.fps)


def gt_centres(poses) -> np.ndarray:
    """Camera centres of the rendered trajectory in the first camera's frame."""
    return np.stack([(poses[0] @ np.linalg.inv(T))[:3, 3] for T in poses])


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def sim3_alignment(est: np.ndarray, gt: np.ndarray):
    """The similarity (Umeyama) that maps estimated centres onto the truth,
    as a function of (n, 3) centres."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(E))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    scale = np.trace(np.diag(D) @ S) / max((E ** 2).sum() / len(E), 1e-12)
    return lambda c: scale * (c - mu_e) @ (U @ S @ Vt).T + mu_g


def ate_rmse_sim3(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE after a similarity alignment, for monocular runs whose scale and
    frame are free."""
    return ate_rmse(sim3_alignment(est, gt)(est), gt)


# Phase 9: after two uniform grey frames (the second a relocalization
# attempt with no feature), the orbit frames a path sends again.
RELOC_STEPS = {"rgbd": range(80, 84), "localization": range(120, 124),
               "stereo": range(80, 84), "monocular": range(80, 84)}


def grey_frame(cfg, device) -> tuple:
    """A uniform grey frame (128) in the sensor's wire encoding, depth 2 m
    for RGB-D: no FAST corner, so no feature."""
    h, w = cfg.camera.height, cfg.camera.width
    img = torch.full((h, w), 128, dtype=torch.uint8, device=device)
    if cfg.sensor == "rgbd":
        return img, torch.full((h, w), 2000, dtype=torch.int32, device=device).to(torch.uint16)
    return (img, img.clone()) if cfg.sensor == "stereo" else (img,)


def reloc_episode(track, frames, grey, path: str, t0: int) -> list:
    """Phase 9's frames through ``track(frame, i)``: two grey frames, then
    the path's orbit frames; returns what each call returned."""
    steps = [grey, grey] + [frames[i] for i in RELOC_STEPS[path]]
    return [track(f, t0 + k) for k, f in enumerate(steps)]


def centre_error(pose, gt_centre, align=None) -> float:
    """Distance of a returned Tcw's camera centre from the rendered one,
    after ``align`` (a monocular run's similarity) where given."""
    c = -(pose[:3, :3].T @ pose[:3, 3])
    if align is not None:
        c = align(c[None])[0]
    return float(np.linalg.norm(c - gt_centre))


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _interleaved_ms(kern, plain, n: int = 20):
    """CUDA-event medians of ``kern`` and ``plain`` over n runs each, in
    turns (plain, kernel, kernel, plain, ...) after 3 warm-up runs each."""
    for _ in range(3):
        kern()
        plain()
    ms = {kern: [], plain: []}
    for i in range(n):
        for fn in ((plain, kern) if i % 2 == 0 else (kern, plain)):
            start, end = _events()
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms[fn].append(start.elapsed_time(end))
    return float(np.median(ms[kern])), float(np.median(ms[plain]))


def _device_ms(fn, needle: str, n: int = 20) -> float:
    """Median device-side duration (ms) of the kernel whose name holds
    ``needle`` over n calls of ``fn`` in a torch.profiler trace, after 3
    warm-up calls: the kernel's own time, which is held against the bound."""
    for _ in range(3):
        fn()
    # a trace now and then lacks one launch's event (seen once in some fifty
    # traces on an H100, and on one machine in three traces in a row): the
    # median of the n - 1 left is kept; a trace that lacks more is taken
    # again, twice at most
    for attempt in range(3):
        torch.cuda.synchronize()
        dev, _, _ = _trace(lambda: [fn() for _ in range(n)])
        ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in dev if needle in e.name]
        if len(ms) != n:
            print(f"trace {attempt + 1} holds {len(ms)} device events named *{needle}* for "
                  f"{n} launches ({len(dev)} device events)")
        if n - 1 <= len(ms) <= n:
            return float(np.median(ms))
    raise AssertionError(f"three traces in a row lack device events named *{needle}*")


# Published peaks of one NVIDIA H100 SXM at its full 700 W: device memory
# rate, and the float32 rate outside the tensor cores, which is taken here
# for the 32-bit integer, compare and popcount operations of these kernels
# too (the card has no higher rate for them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
OPS_PER_WINDOW_TEST = 8      # 2 subtractions, 2 abs, 2 compares with r, 1 octave
                             # difference with 2 compares, the ANDs folded
OPS_PER_PAIR = 16            # 8 XOR + 8 POPC over the 8 descriptor words


def _bound(tensors, n1: int, ops: float) -> dict:
    """The least time the card could take: every input read once and the
    3 x (n1,) int32 result written once over the memory rate, or ``ops``
    over the non-tensor rate, whichever is larger."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + 3 * n1 * 4
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": int(ops)}


def _window_bound(args, band) -> dict:
    """Bound of one window_match call on these inputs: a window test for
    every (valid row, valid column), a popcount pair for every candidate."""
    from refactored_orb_slam2_tpu_torch.ops import matching as M

    _, _, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t = args
    cand = (M.window_mask(uv_q, uv_t, radius)
            & M.octave_band_mask(oct_q, oct_t, band[0], band[1])
            & valid_q[:, None] & valid_t[None, :])
    tests, pairs = int(valid_q.sum()) * int(valid_t.sum()), int(cand.sum())
    out = _bound(args, args[0].shape[0], OPS_PER_WINDOW_TEST * tests + OPS_PER_PAIR * pairs)
    return dict(out, window_tests=tests, candidate_pairs=pairs)


def _masked_bound(args) -> dict:
    """Bound of one hamming_best2 call: a popcount pair for every set mask
    entry; the mask itself is N1 x N2 bytes of input."""
    pairs = int(args[2].sum())
    return dict(_bound(args, args[0].shape[0], OPS_PER_PAIR * pairs), candidate_pairs=pairs)


def _measure(name, shape, kern, plain, needle, floor_fn, bound, card) -> dict:
    """Times of one kernel at one shape: the kernel's own duration on the
    device (trace), the same at N1 = N2 = 1 (what any launch costs), the
    CUDA-event time around the wrapper (what a caller waits) beside the
    plain version's, and the share of the bound."""
    device_ms = _device_ms(kern, needle)
    floor_ms = _device_ms(floor_fn, needle)
    ms, plain_ms = _interleaved_ms(kern, plain)
    share = bound["bound_ms"] / device_ms
    print(f"kernel time, {name} at {shape}: device-side {device_ms:.5f} ms (median of 20 "
          f"launches in a torch.profiler trace), floor at 1x1 {floor_ms:.5f} ms, "
          f"bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
          f"({bound['bytes']} B, {bound['operations']} operations, "
          f"{bound['candidate_pairs']} candidate pairs), share of bound {share:.4f}; "
          f"a caller waits {ms:.4f} ms, plain version {plain_ms:.4f} ms "
          f"(medians of 20, CUDA events around the call; {card})")
    if share > 1.05:
        raise AssertionError(f"{name} at {shape}: share of bound {share:.3f} > 1.05, "
                             "so the bound counts more work than the kernel did")
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            "floor_ms": floor_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None}


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)


def _dev(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")


def _strided(t):
    """The same values as a non-contiguous view (every second row of a
    tensor twice as long)."""
    return t.repeat_interleave(2, dim=0)[::2]


def _window_case(rng, n1, n2, radius_range, band, p_valid, views=False, extent=640):
    """One window_match call against its plain version; ``extent`` is the
    image size the pixel positions are drawn in, a side or (width, height)."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    args = (
        _dev(_words(rng, n1)), _dev(_words(rng, n2)),
        _dev(rng.uniform(0, extent, (n1, 2)).astype(np.float32)),
        _dev(rng.uniform(0, extent, (n2, 2)).astype(np.float32)),
        _dev(rng.uniform(*radius_range, n1).astype(np.float32)),
        _dev(rng.integers(0, 8, n1).astype(np.int32)),
        _dev(rng.integers(0, 8, n2).astype(np.int32)),
        _dev(rng.random(n1) < p_valid), _dev(rng.random(n2) < p_valid),
    )
    if views:
        args = tuple(_strided(t) for t in args)
    d1, i1, d2 = cuda_hamming.window_match(*args, band)
    r1, ri, r2 = cuda_hamming.window_match_reference(*args, band)
    torch.cuda.synchronize()
    if not (torch.equal(d1, r1) and torch.equal(d2, r2) and torch.equal(i1, ri)):
        raise AssertionError(f"window kernel disagrees with its plain version at {n1}x{n2}")
    for ratio in (0.7, 0.9):
        gk = (d1 <= 256) & (d1.float() < ratio * d2.float())
        gr = (r1 <= 256) & (r1.float() < ratio * r2.float())
        if not torch.equal(gk, gr):
            raise AssertionError(f"ratio gate {ratio} differs at {n1}x{n2}")
    err = max(int((d1 - r1).abs().max()), int((d2 - r2).abs().max()),
              int((i1 - ri).abs().max()))
    print(f"window kernel {n1}x{n2} band {band}{' (strided views)' if views else ''}: "
          f"equal (max_abs_err {err}, {int((r1 < (1 << 20)).sum())} rows with a candidate)")
    return args, err


def _masked_case(rng, name, n_feat=1000, extent=640):
    """(desc_a, desc_b, mask) on the card for the phase-3 shapes; ``n_feat``
    and ``extent`` are the feature slots and the image size (a side or
    (width, height)) of the fuse and triangulation shapes."""
    from refactored_orb_slam2_tpu_torch.ops import matching as M

    if name == "fuse":            # projected candidates vs keyframe features
        n1, n2 = 2048, n_feat
        uv_a = _dev(rng.uniform(0, extent, (n1, 2)).astype(np.float32))
        uv_b = _dev(rng.uniform(0, extent, (n2, 2)).astype(np.float32))
        radius = _dev((3.0 * 1.2 ** rng.integers(0, 8, n1)).astype(np.float32) * 8)
        oct_a = _dev(rng.integers(0, 8, n1).astype(np.int32))
        oct_b = _dev(rng.integers(0, 8, n2).astype(np.int32))
        mask = M.window_mask(uv_a, uv_b, radius) & M.octave_band_mask(oct_a, oct_b, -1, 1)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "rescue":        # relocalization rescue: keyframe slots vs frame features
        n1 = n2 = n_feat
        uv_a = _dev(rng.uniform(0, extent, (n1, 2)).astype(np.float32))
        uv_b = _dev(rng.uniform(0, extent, (n2, 2)).astype(np.float32))
        oct_a = _dev(rng.integers(0, 8, n1).astype(np.int32))
        oct_b = _dev(rng.integers(0, 8, n2).astype(np.int32))
        radius = 10.0 * 1.2 ** oct_a.to(torch.float32)            # th 10 x scale
        mask = M.window_mask(uv_a, uv_b, radius) & M.octave_band_mask(oct_a, oct_b, -1, 1)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "loop fuse":      # SearchAndFuse: window th 4 x scale, octave band +-1
        n1, n2 = 1024, n_feat
        uv_a = _dev(rng.uniform(0, extent, (n1, 2)).astype(np.float32))
        uv_b = _dev(rng.uniform(0, extent, (n2, 2)).astype(np.float32))
        oct_a = _dev(rng.integers(0, 4, n1).astype(np.int32))
        oct_b = _dev(rng.integers(0, 4, n2).astype(np.int32))
        radius = 4.0 * 1.2 ** oct_a.to(torch.float32)
        mask = M.window_mask(uv_a, uv_b, radius) & M.octave_band_mask(oct_a, oct_b, -1, 1)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "projection count":   # the loop's acceptance count: 10 px, no band
        n1, n2 = 2048, n_feat
        uv_a = _dev(rng.uniform(0, extent, (n1, 2)).astype(np.float32))
        uv_b = _dev(rng.uniform(0, extent, (n2, 2)).astype(np.float32))
        mask = M.window_mask(uv_a, uv_b, 10.0)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "triangulation":  # a band like an epipolar one
        n1 = n2 = n_feat
        i, j = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
        mask = _dev(np.abs(i * 1.1 - j + rng.integers(-30, 31, (n1, 1))) <= 25)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "stereo":         # stereo_match: row, disparity and octave gates
        n1 = n2 = 1200
        xy_l = rng.uniform(0, (752, 480), (n1, 2)).astype(np.float32)
        pick = rng.integers(0, n1, n2)                  # most right features have a twin
        xy_r = xy_l[pick] - np.stack([rng.uniform(2, 60, n2), rng.normal(0, 1.0, n2)], 1)
        oct_l = rng.integers(0, 8, n1).astype(np.int32)
        oct_r = np.clip(oct_l[pick] + rng.integers(-1, 2, n2), 0, 7).astype(np.int32)
        uv_l, uv_r = _dev(xy_l), _dev(xy_r.astype(np.float32))
        r_row = _dev((2.0 * 1.2 ** oct_r).astype(np.float32))
        disp = uv_l[:, 0:1] - uv_r[None, :, 0]
        mask = ((torch.abs(uv_r[None, :, 1] - uv_l[:, 1:2]) <= r_row[None, :])
                & M.octave_band_mask(_dev(oct_l), _dev(oct_r), -1, 1)
                & (disp >= 0) & (disp <= 435.2))
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "random":
        n1, n2 = 1000, 1500
        mask = _dev(rng.random((n1, n2)) < 0.3)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "ragged":        # ragged, empty rows, ties
        n1, n2 = 777, 1031
        m = rng.random((n1, n2)) < 0.5
        m[rng.choice(n1, 60, replace=False)] = False
        mask = _dev(m)
        b = _words(rng, n2)
        b[n2 // 2:2 * (n2 // 2)] = b[:n2 // 2]          # every column has a twin
        a = np.concatenate([b[rng.choice(n2, 500)], _words(rng, n1 - 500)])
    else:
        # (n1, n2, density, layout): twins in the bank (ties at the best),
        # a tenth of the rows empty; the mask contiguous, a strided view, a
        # transposed view, or contiguous from an odd byte offset
        n1, n2, density, layout = name
        m = rng.random((n1, n2)) < density
        m[rng.choice(n1, n1 // 10, replace=False)] = False
        b = _words(rng, n2)
        b[n2 // 2:2 * (n2 // 2)] = b[:n2 // 2]
        a = np.concatenate([b[rng.choice(n2, n1 // 2)], _words(rng, n1 - n1 // 2)])
        if layout == "strided":
            mask = _dev(np.repeat(m, 2, axis=1))[:, ::2]
        elif layout == "transposed":
            mask = _dev(m.T).t()
        elif layout == "odd offset":
            mask = _dev(np.concatenate([np.zeros(3, bool), m.ravel()]))[3:].view(n1, n2)
        else:
            mask = _dev(m)
    return _dev(a), _dev(b), mask


def _masked_check(rng, name, **size):
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    a, b, mask = _masked_case(rng, name, **size)
    got = cuda_hamming.hamming_best2(a, b, mask)
    ref = cuda_hamming.hamming_best2_reference(a, b, mask)
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"masked kernel disagrees with its plain version at {name}")
    err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
    d1, _, d2 = ref
    label = name if isinstance(name, str) else f"{name[3]} mask, density {name[2]},"
    print(f"masked kernel {label} {a.shape[0]}x{b.shape[0]}: equal (max_abs_err {err}, "
          f"mask density {float(mask.float().mean()):.4f}, "
          f"{int((d1 < (1 << 20)).sum())} rows with a candidate, "
          f"{int(((d1 == d2) & (d1 < (1 << 20))).sum())} ties at the best)")
    return (a, b, mask), err


_TRACK_STAGES = (  # (module or class path, attribute, label)
    ("system.SlamSystem", "_build_frame", "frame build (ORB + depth or stereo match)"),
    ("system.TK", "match_motion_model", "motion-model match (2 windows)"),
    ("system", "optimize_pose", "pose-only LM (2 calls)"),
    ("system.TK", "select_local_points", "select local points"),
    ("system.TK", "match_local_points", "match local points (kernel inside)"),
)
_MAP_STAGES = (
    ("system.SlamSystem", "_insert_kf_with_points", "insert keyframe + depth points"),
    ("system.SlamSystem", "_work_sets", "work sets (+ slot-list read)"),
    ("system.SlamSystem", "_triangulate_new_points", "triangulation (kernel inside)"),
    ("system.SlamSystem", "_fuse_neighbors", "fuse, both directions (kernel inside)"),
    ("system.SlamSystem", "_cull_and_refresh", "cull recent points + statistics"),
    ("system.SlamSystem", "_reconcile_triangulation", "triangulation reconcile (read)"),
    ("system.SlamSystem", "_windowed_ba", "local BA (gather, 15 LM its, scatter)"),
    ("system.SlamSystem", "_cull_keyframes", "keyframe culling"),
)


@contextlib.contextmanager
def _stage_timers(stages, totals: dict, counts: dict | None = None):
    """Wrap ``stages`` with a synchronize on each side and add each call's
    host-clock time to ``totals[label]`` (and one to ``counts[label]``);
    restore on exit."""
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
            if counts is not None:
                counts[label] = counts.get(label, 0) + 1
            return out
        return run

    saved = [(owner(path), name, getattr(owner(path), name)) for path, name, _ in stages]
    for (obj, name, fn), (_, _, label) in zip(saved, stages):
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


def _trace(fn):
    """Run ``fn`` under torch.profiler; return (device events, profiler,
    traced wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dev, prof, wall_ms


@contextlib.contextmanager
def _sync_sites(sites: collections.Counter):
    """Count the host synchronizations CUDA sync-debug mode flags, by site."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites.update(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message))


def _frame_stages(slam, frames, card: str) -> int:
    """Synchronized stage times of 4 tracked frames on a fresh system: the
    frames up to the first tracked one (frame 0, or where the monocular
    initializer succeeds), 3 more to warm up, then 4 under the stage
    timers.  Returns the index of the next frame."""
    i = 0
    while track_device(slam, frames[i], i) is None:
        i += 1
    for i in range(i + 1, i + 4):
        track_device(slam, frames[i], i)
    torch.cuda.synchronize()
    first = i + 1
    totals, n, whole, n_kf = {}, 4, "whole frame, stages synchronized", slam.n_kf
    with _stage_timers(_TRACK_STAGES, totals):
        for i in range(first, first + n):
            t0 = time.perf_counter()
            track_device(slam, frames[i], i)
            torch.cuda.synchronize()
            totals[whole] = totals.get(whole, 0.0) + time.perf_counter() - t0
    for label, t in totals.items():
        print(f"stage {label}, {slam.sensor}: {t / n * 1e3:.2f} ms/frame "
              f"(frames {first}-{first + n - 1}; {card})")
    if slam.n_kf != n_kf:
        print(f"stage window, {slam.sensor}: {slam.n_kf - n_kf} of its {n} frames inserted a "
              "keyframe, whose mapping is in the whole-frame time and in no stage")
    return first + n


def _breakdown(slam, frames, frame_ms: float, n_kf_expected: int, card: str) -> None:
    """Phase 5 on a fresh RGB-D system over the same frames."""
    track = lambda i: track_device(slam, frames[i], i)
    if _frame_stages(slam, frames, card) != 8:
        raise AssertionError("the stage window of the RGB-D breakdown is not frames 4-7")

    n = 3
    dev, prof, wall_ms = _trace(lambda: [track(i) for i in range(8, 8 + n)])
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

    sites = collections.Counter()
    with _sync_sites(sites):
        for i in range(11, 14):
            track(i)
    print(f"host syncs, frames 11-13 (tracked, no keyframe): "
          f"{sum(sites.values()) / 3:.1f} per frame at "
          + (", ".join(f"{k} x{v}" for k, v in sorted(sites.items())) or "none"))

    # keyframes: synchronized mapping stages, host syncs of each keyframe's
    # insertion and mapping, and a trace of one keyframe's mapping
    map_totals, kf_sites, traced = {}, collections.Counter(), {}
    create = slam._create_keyframe

    def watched(*args, **kwargs):
        if slam.n_kf == 4 and not traced:      # the keyframe that makes n_kf 5
            untraced = dict(map_totals)        # its stage times are left out
            dev, prof, wall = _trace(lambda: create(*args, **kwargs))
            map_totals.clear()
            map_totals.update(untraced)
            traced.update(dev=dev, prof=prof, wall=wall)
            return None
        with _sync_sites(kf_sites):
            return create(*args, **kwargs)

    slam._create_keyframe = watched
    n_before = slam.n_kf
    with _stage_timers(_MAP_STAGES, map_totals):
        for i in range(14, len(frames)):
            track(i)
    del slam._create_keyframe
    n_timed = slam.n_kf - n_before - (1 if traced else 0)   # untraced keyframes
    for label, t in map_totals.items():
        print(f"mapping stage {label}: {t / max(n_timed, 1) * 1e3:.2f} ms/keyframe "
              f"({n_timed} untraced keyframes; {card})")
    print(f"host syncs per keyframe in insertion + mapping: "
          f"{sum(kf_sites.values()) / max(n_timed, 1):.1f} over {n_timed} keyframes at "
          + (", ".join(f"{k} x{v}" for k, v in sorted(kf_sites.items())) or "none"))
    if traced.get("dev"):
        busy = _busy_us(traced["dev"]) / 1e3
        launches = sum(e.count for e in traced["prof"].key_averages()
                       if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
        print(f"trace, keyframe slot 4 (insertion + mapping + culling check): "
              f"device busy {busy:.2f} ms, traced wall {traced['wall']:.2f} ms, "
              f"{len(traced['dev'])} device events, {launches} kernel launches "
              f"({card})")
    if slam.n_kf != n_kf_expected or len(slam.tracked_logs()) != len(frames):
        raise AssertionError(
            f"the breakdown run ended with n_kf {slam.n_kf} and "
            f"{len(slam.tracked_logs())} tracked frames, phase 4 with "
            f"{n_kf_expected} and {len(frames)}")


def _sequence(cfg, frames, poses, ate_bound: float, card: str):
    """Track every frame of one sensor's sequence on a fresh system, with
    the per-keyframe checks; prints the path's lines and returns the system
    and its results.  A monocular run may return None before its
    initializer succeeds; after the first tracked frame no sensor may."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    slam = SlamSystem(cfg, device="cuda")
    mono = cfg.sensor == "monocular"
    mapped, tri, ba, detections = [], [], [], []
    steps, reconcile, local_ba, close_loop = (slam._mapping_steps, slam._reconcile_triangulation,
                                              slam._windowed_ba, slam._try_close_loop)

    def timed_steps(kf_slot):
        """Mapping time per keyframe (synchronized) and its masked launches."""
        before = cuda_hamming.launches["hamming_best2"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(kf_slot)
        torch.cuda.synchronize()
        mapped.append((kf_slot, time.perf_counter() - t0,
                       cuda_hamming.launches["hamming_best2"] - before))

    def counted_reconcile(n_new, pt_base):
        reconcile(n_new, pt_base)
        tri.append(slam.n_pt - pt_base)          # points the triangulation kept

    def counted_ba(*args, **kwargs):
        ba.append(slam.n_kf)
        return local_ba(*args, **kwargs)

    def timed_loop(kf_slot):
        """Loop closing (synchronized) of the keyframes that reach detection."""
        reached = slam.db is not None and slam.n_kf >= slam.cfg.loop.kf_gap + 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        closed = close_loop(kf_slot)
        torch.cuda.synchronize()
        if reached:
            detections.append((kf_slot, time.perf_counter() - t0, closed))
        return closed

    slam._mapping_steps = timed_steps
    slam._reconcile_triangulation = counted_reconcile
    slam._windowed_ba = counted_ba
    slam._try_close_loop = timed_loop

    torch.cuda.reset_peak_memory_stats()
    times, out, kf_frames, init_sites = [], [], [], collections.Counter()
    cuda_hamming.reset_launches()
    for i, frame in enumerate(frames):
        n_kf = slam.n_kf
        t0 = time.perf_counter()
        if mono and n_kf == 0:
            # an initialization attempt: keep the host syncs of the accepted one
            sites = collections.Counter()
            with _sync_sites(sites):
                pose = track_device(slam, frame, i)
            if pose is not None:
                init_sites = sites
        else:
            pose = track_device(slam, frame, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append(pose)
        if slam.n_kf != n_kf:
            kf_frames.append(i)
    launches = dict(cuda_hamming.launches)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    n = len(frames)
    tracked = [p is not None for p in out]
    if True not in tracked:
        raise AssertionError(f"{cfg.sensor}: no frame was tracked (initialization never succeeded)")
    first = tracked.index(True)
    n_after, n_tracked = n - first, sum(tracked)
    est = slam.frame_poses()
    if est.shape != (n_tracked, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"{cfg.sensor}: poses {est.shape} for {n_tracked} tracked frames")
    if (n_tracked < 0.9 * n_after) if mono else (first != 0 or n_tracked != n):
        raise AssertionError(f"{cfg.sensor}: tracked {n_tracked} of the {n_after} frames "
                             f"from the first tracked one (frame {first})")
    if slam.n_kf < 3:
        raise AssertionError(f"{cfg.sensor}: n_kf = {slam.n_kf}, expected >= 3")
    # a monocular map starts with two keyframes, which are not mapped; every
    # later one must triangulate points, its only source of new ones
    first_mapped = 2 if mono else 1
    if not ba or not tri or (min(tri) <= 0 if mono else max(tri) <= 0):
        raise AssertionError(f"{cfg.sensor}: local BAs {ba}, points triangulated per "
                             f"keyframe {tri}")
    if [k for k, _, _ in mapped] != list(range(first_mapped, slam.n_kf)):
        raise AssertionError(f"{cfg.sensor}: mapped keyframes {[k for k, _, _ in mapped]}")
    if min(m for _, _, m in mapped) < 1:
        raise AssertionError(f"{cfg.sensor}: masked-kernel launches per keyframe "
                             f"{[m for *_, m in mapped]}")
    if launches["window_match"] < n_tracked - 1:
        raise AssertionError(f"{cfg.sensor}: window_match launched {launches['window_match']} "
                             f"times in {n_tracked - 1} tracked frames")
    # stereo_match runs one masked search per frame, apart from mapping's
    in_frames = launches["hamming_best2"] - sum(m for _, _, m in mapped)
    if in_frames != (n if cfg.sensor == "stereo" else 0):
        raise AssertionError(f"{cfg.sensor}: {in_frames} masked-kernel launches outside "
                             f"local mapping in {n} frames")
    gt = gt_centres(poses)[slam.tracked_frame_ids()]
    ate = (ate_rmse_sim3 if mono else ate_rmse)(slam.camera_centers(), gt)
    if not ate < ate_bound:
        raise AssertionError(f"{cfg.sensor}: ATE {ate:.6f} m >= bound {ate_bound:.6f} m")
    # loop closing is on: RGB-D and stereo map too few keyframes to reach
    # detection; monocular reaches it and must close a loop where the JAX
    # package's run does (the two maps' keyframe slots differ)
    loops = [k for k, _, closed in detections if closed]
    n_jax, jax_loops = JAX_LOOP_DETECTION[cfg.sensor]
    if (bool(detections) != bool(n_jax)) or (bool(loops) != bool(jax_loops)):
        raise AssertionError(f"{cfg.sensor}: loop detection at {len(detections)} keyframes, "
                             f"loops at {loops}; the JAX package: {n_jax}, {jax_loops}")

    ms = np.asarray(times) * 1e3
    kf_mask = np.zeros(n, bool)
    kf_mask[kf_frames] = True
    steady = ~kf_mask & np.asarray(tracked)
    steady[:first + 2] = False
    map_ms = [t * 1e3 for _, t, _ in mapped]
    name = cfg.sensor
    print(f"{name} sequence: {n_tracked}/{n_after} tracked from frame {first} (the first "
          f"tracked frame), lost {n_after - n_tracked}, n_kf {slam.n_kf}, n_pt {slam.n_pt}, "
          f"keyframe frames {kf_frames}, culled keyframes {sorted(slam.culled_chain)}, "
          f"{'Sim3-aligned ' if mono else ''}ATE {ate:.6f} m (bound {ate_bound:.6f} m from "
          f"the JAX run's), tracking paths {slam.stats}")
    print(f"{name} sequence mapping: local BAs at n_kf {ba}, points triangulated per "
          f"keyframe {tri}, masked-kernel launches per keyframe "
          f"{[m for *_, m in mapped]}, masked-kernel launches in stereo_match "
          f"{in_frames}, launches {launches}")
    print(f"{name} sequence frame time: median {np.median(ms[first + 2:]):.2f} ms over frames "
          f"{first + 2}-{n - 1}; without keyframe frames {np.median(ms[steady]):.2f} ms; "
          f"keyframe frames median {np.median(ms[kf_mask]):.2f} ms "
          f"(host clock with synchronize; {card})")
    print(f"{name} sequence mapping time per keyframe (synchronized): median "
          f"{np.median(map_ms):.2f} ms, each " + " ".join(f"{t:.2f}" for t in map_ms)
          + f" ms ({card})")
    print(f"{name} per-frame ms: " + " ".join(f"{t:.2f}" for t in ms))
    print(f"{name} sequence peak device memory: {peak_mib:.1f} MiB ({card})")
    det_ms = [t * 1e3 for _, t, _ in detections]
    print(f"{name} sequence loop closing (on): detection at {len(detections)} keyframes (the "
          f"JAX package's run: {n_jax}), loops closed at keyframes {loops} (JAX: {jax_loops})"
          + (f", loop closing per keyframe that reached detection (synchronized): median "
             f"{np.median(det_ms):.2f} ms, max {max(det_ms):.2f} ms ({card})" if det_ms else ""))
    if mono:
        print(f"monocular initialization accepted at frame {first}: "
              f"{sum(init_sites.values())} host syncs in that frame at "
              + ", ".join(f"{k} x{v}" for k, v in sorted(init_sites.items())))
    return slam, dict(launches=launches, n_kf=slam.n_kf,
                      steady_ms=float(np.median(ms[steady])),
                      median_ms=float(np.median(ms[first + 2:])))


def _localization(slam, frames, card: str) -> dict:
    """Phase 6: the frozen map of the RGB-D run, the last frames again in
    reverse order through the decomposed path."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    n_kf, n_pt, n_logged = slam.n_kf, slam.n_pt, len(slam.tracked_logs())
    slam.activate_localization_mode()
    cuda_hamming.reset_launches()
    order = list(range(len(frames) - 1, len(frames) - 1 - N_LOCALIZATION, -1))
    watched = range(10, 13)                  # steps under sync-debug mode
    times, sites = [], collections.Counter()
    for k, i in enumerate(order):
        t0 = time.perf_counter()
        with (_sync_sites(sites) if k in watched else contextlib.nullcontext()):
            pose = track_device(slam, frames[i], len(frames) + k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if pose is None or not np.isfinite(pose).all():
            raise AssertionError(f"localization-only: frame {i} (step {k}) was not tracked")
    launches = dict(cuda_hamming.launches)
    slam.deactivate_localization_mode()
    if (slam.n_kf, slam.n_pt) != (n_kf, n_pt):
        raise AssertionError(f"localization-only changed the map: n_kf {n_kf} -> {slam.n_kf}, "
                             f"n_pt {n_pt} -> {slam.n_pt}")
    if len(slam.tracked_logs()) != n_logged + N_LOCALIZATION:
        raise AssertionError("localization-only frames missing from the trajectory")
    if launches["window_match"] < N_LOCALIZATION or launches["hamming_best2"] != 0:
        raise AssertionError(f"localization-only launches {launches}")
    timed = [t for k, t in enumerate(times) if k >= 2 and k not in watched]
    print(f"localization-only: {N_LOCALIZATION}/{N_LOCALIZATION} tracked (frames "
          f"{order[0]} down to {order[-1]}), n_kf {slam.n_kf} and n_pt {slam.n_pt} unchanged, "
          f"tracking paths {slam.stats}, launches {launches}")
    print(f"localization-only frame time: median {np.median(timed):.2f} ms "
          f"(host clock with synchronize; {card})")
    print(f"host syncs per localization-only frame (steps {watched[0]}-{watched[-1]}): "
          f"{sum(sites.values()) / len(watched):.1f}, beside the fused path's 2, at "
          + ", ".join(f"{k} x{v}" for k, v in sorted(sites.items())))
    return launches


def _relocalization(slam, frames, poses, path: str, t0: int, card: str, align=None) -> dict:
    """Phase 9 on one system: two grey frames, then the path's orbit frames
    (``reloc_episode``).  Asserts LOST after the grey frames, no
    relocalization on them, one at the orbit frame where the JAX package's
    happened, its camera centre within RELOC_BOUND_M[path] of the rendered
    one, the frames after it tracked, a window_match launch on the
    relocalization frame and, in localization-only mode, the map unchanged;
    where the JAX package does not relocalize (JAX_RELOC[path] is None) it
    only prints.  The relocalization frame runs under sync-debug mode.  Then
    the rescue search at the accepted pose (th 10, dist 100) is run once
    more with its masked search's inputs kept, and hamming_best2 is held
    against its plain version on exactly those tensors (launch counts put
    back).  Returns the episode's launches and that comparison's error."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    expect = JAX_RELOC.get(path)
    steps = list(RELOC_STEPS[path])
    gt = gt_centres(poses)
    relocs, n_map = slam.stats["relocs"], (slam.n_kf, slam.n_pt)
    calls, sites, kept = [], collections.Counter(), {}

    def track(frame, i):
        k = len(calls)
        before = dict(cuda_hamming.launches)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        with (_sync_sites(sites) if k == 2 else contextlib.nullcontext()):
            pose = track_device(slam, frame, i)
        torch.cuda.synchronize()
        calls.append(dict(pose=pose, state=slam.state, relocs=slam.stats["relocs"],
                          ms=(time.perf_counter() - t_start) * 1e3,
                          launches={n: cuda_hamming.launches[n] - before[n] for n in before}))
        accepted = [r for r in slam.reloc_log if r["accepted"]]
        if accepted and not kept:
            kept.update(log=[dict(r) for r in slam.reloc_log], rec=accepted[0])
            saved = dict(cuda_hamming.launches)
            best2 = cuda_hamming.hamming_best2
            cuda_hamming.hamming_best2 = lambda *a: kept.update(args=a) or best2(*a)
            try:
                slam._reloc_rescue(accepted[0]["frame"], accepted[0]["pose"],
                                   accepted[0]["cand"], accepted[0]["pt_idx"], 10.0, 100)
            finally:
                cuda_hamming.hamming_best2 = best2
            cuda_hamming.launches.update(saved)
        return pose

    torch.cuda.reset_peak_memory_stats()
    cuda_hamming.reset_launches()
    reloc_episode(track, frames, grey_frame(slam.cfg, "cuda"), path, t0)
    launches = dict(cuda_hamming.launches)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    grey, orbit = calls[:2], calls[2:]
    hit = next((k for k, c in enumerate(orbit) if c["pose"] is not None), None)
    err = (None if hit is None
           else centre_error(orbit[hit]["pose"], gt[steps[hit]], align))
    after = 0 if hit is None else sum(c["pose"] is not None for c in orbit[hit + 1:])
    log = kept.get("log", [])
    print(f"relocalization, {path}: state {grey[1]['state']} after the grey frames (returned "
          f"{[c['pose'] for c in grey]}), relocalized at orbit frame "
          f"{None if hit is None else steps[hit]} (the JAX package: "
          f"{'none' if expect is None else expect[0]}), centre error "
          f"{'-' if err is None else f'{err:.6f}'} m (bound "
          f"{RELOC_BOUND_M.get(path, '-')} m; JAX {'-' if expect is None else expect[1]} m), "
          f"{after} of the {len(orbit) - 1 - (hit or 0)} orbit frames after it tracked, "
          f"relocs +{slam.stats['relocs'] - relocs}, reloc_rejects {slam.stats['reloc_rejects']}, "
          f"n_kf {n_map[0]} -> {slam.n_kf}, n_pt {n_map[1]} -> {slam.n_pt}")
    print(f"relocalization, {path}: candidates tried {[r['cand'] for r in log]}, SearchByBoW "
          f"matches {[r.get('bow_matches') for r in log]}, EPnP inliers "
          f"{[r.get('epnp_inliers') for r in log]}, pose-LM inliers "
          f"{[r.get('lm_inliers') for r in log]}, rescue rounds "
          f"{[r['rescue_rounds'] for r in log]}")
    if hit is not None:
        frame = orbit[hit]
        print(f"relocalization frame, {path}: {frame['ms']:.2f} ms (host clock with synchronize, "
              f"sync-debug mode on; {card}), {sum(sites.values())} host syncs at "
              + ", ".join(f"{k} x{v}" for k, v in sorted(sites.items()))
              + f"; its launches {frame['launches']}; the episode's {launches}; peak device "
              f"memory {peak_mib:.1f} MiB ({card})")
    err_best2 = 0
    if "args" in kept:
        a, b, mask = kept["args"]
        got = cuda_hamming.hamming_best2(*kept["args"])
        ref = cuda_hamming.hamming_best2_reference(*kept["args"])
        torch.cuda.synchronize()
        cuda_hamming.launches.update(launches)       # a comparison launch: not the path's
        err_best2 = max(int((g - r).abs().max()) for g, r in zip(got, ref))
        print(f"relocalization, {path}: hamming_best2 on the rescue search's own tensors "
              f"({a.shape[0]}x{b.shape[0]}, mask density {float(mask.float().mean()):.4f}, "
              f"{int(mask.sum())} candidate pairs): "
              f"{'equal' if err_best2 == 0 else 'DIFFERS'} (max_abs_err {err_best2})")
        if err_best2:
            raise AssertionError(f"{path}: hamming_best2 differs from its plain version on the "
                                 "rescue search's tensors")
    if expect is None:
        if hit is not None:
            print(f"relocalization, {path}: relocalized where the JAX package did not")
        return dict(launches=launches, err=err_best2)
    if grey[1]["state"] != 2 or any(c["pose"] is not None for c in grey):
        raise AssertionError(f"{path}: not LOST after the grey frames")
    if hit is None or steps[hit] != expect[0] or slam.stats["relocs"] - relocs != 1:
        raise AssertionError(f"{path}: relocalized at {None if hit is None else steps[hit]} "
                             f"({slam.stats['relocs'] - relocs} relocs), the JAX package at "
                             f"{expect[0]}")
    if not err < RELOC_BOUND_M[path]:
        raise AssertionError(f"{path}: relocalized centre {err:.6f} m from the rendered one, "
                             f"bound {RELOC_BOUND_M[path]:.6f} m")
    if after != len(orbit) - 1 - hit:
        raise AssertionError(f"{path}: {after} frames tracked after the relocalization")
    if orbit[hit]["launches"]["window_match"] < 1:
        raise AssertionError(f"{path}: no window_match launch on the relocalization frame")
    if "args" not in kept:
        raise AssertionError(f"{path}: the rescue search's masked search was not captured")
    if path == "localization" and (slam.n_kf, slam.n_pt) != n_map:
        raise AssertionError(f"localization-only relocalization changed the map: {n_map} -> "
                             f"{(slam.n_kf, slam.n_pt)}")
    return dict(launches=launches, err=err_best2)


_LOOP_STAGES = (
    ("system.LC", "detect", "detect (candidates, chain; one read)"),
    ("system.LC", "compute_sim3", "compute_sim3 (one candidate)"),
    ("system.LC", "count_loop_projection_matches", "projection count (kernel inside)"),
    ("system.SlamSystem", "_launch_gba", "global BA (10 LM its x 80 CG its)"),
)


def _correct_loop_split(slam, parts: dict):
    """Wrap ``slam._correct_loop`` so that ``parts`` gets its synchronized
    time in four spans: propagation (covisibility read, the group's Sim3 and
    points), fuse (SearchAndFuse into every group keyframe), graph (the
    statistics, LoopConnections, the essential graph's edges and the pose
    graph's 20 LM iterations) and point correction (points, poses, loop
    edge, statistics)."""
    from refactored_orb_slam2_tpu_torch import system

    inner = slam._correct_loop

    def marked(module, name, before, after):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            parts.setdefault(before, time.perf_counter())
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[after] = time.perf_counter()
            return out
        return fn, run

    def split(*args):
        saved = [marked(system.LM, "fuse_into_keyframe", "fuse_start", "fuse_end"),
                 marked(system.PG, "optimize_pose_graph", "graph_start", "graph_end")]
        system.LM.fuse_into_keyframe, system.PG.optimize_pose_graph = (w for _, w in saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            inner(*args)
            torch.cuda.synchronize()
        finally:
            system.LM.fuse_into_keyframe, system.PG.optimize_pose_graph = (f for f, _ in saved)
        t_end = time.perf_counter()
        parts.update(propagation=parts["fuse_start"] - t0,
                     fuse=parts["fuse_end"] - parts["fuse_start"],
                     graph=parts["graph_end"] - parts["fuse_end"],
                     point_correction=t_end - parts["graph_end"], total=t_end - t0)

    slam._correct_loop = split


def _circuit(card: str) -> dict:
    """Phase 10: the stereo street circuit with loop closing on, at the
    card's map capacity.  Asserts at most 2 frames lost, the loop edge at the
    keyframe pair of the JAX package's run, a global BA, the rigidly aligned
    ATE under 1% of the path and under CIRCUIT_ATE_BOUND_M.  Prints the
    loop path's synchronized times, the loop keyframe's host syncs and
    launches, the whole run's launches and the peak device memory.  Returns
    the run's launches."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    cfg, poses = circuit_config(), circuit_poses()
    t0 = time.perf_counter()
    frames = render_circuit(poses, "cuda")
    torch.cuda.synchronize()
    print(f"circuit set-up: {len(frames)} stereo pairs ({cfg.camera.width}x{cfg.camera.height}) "
          f"rendered on the card in {time.perf_counter() - t0:.2f} s")
    slam = SlamSystem(cfg, device="cuda")
    assert slam.loop_closing_enabled
    calls, parts, totals, counts = [], {}, {}, {}
    inner = slam._try_close_loop

    def watched(kf_slot):
        """Every loop-closing call: its time, and under sync-debug mode the
        host syncs of the port's code (the timers' own are left out)."""
        sites, before = collections.Counter(), dict(cuda_hamming.launches)
        reached = slam.db is not None and slam.n_kf >= cfg.loop.kf_gap + 2
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        with _sync_sites(sites):
            closed = inner(kf_slot)
        torch.cuda.synchronize()
        calls.append(dict(kf=kf_slot, frame=slam.frame_id, reached=reached, closed=closed,
                          ms=(time.perf_counter() - t_start) * 1e3,
                          sites={k: v for k, v in sites.items() if "chip_smoke" not in k},
                          launches={n: cuda_hamming.launches[n] - before[n] for n in before}))
        return closed

    slam._try_close_loop = watched
    _correct_loop_split(slam, parts)
    torch.cuda.reset_peak_memory_stats()
    cuda_hamming.reset_launches()
    lost, times = 0, []
    with _stage_timers(_LOOP_STAGES, totals, counts):
        for i, frame in enumerate(frames):
            t_frame = time.perf_counter()
            lost += track_device(slam, frame, i) is None
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_frame) * 1e3)
    launches = dict(cuda_hamming.launches)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    gt = world_centres(poses)
    est = slam.camera_centers()
    ate = ate_rmse_se3(est, gt[slam.tracked_frame_ids()])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    edges = slam.map.kf_loop_edges.cpu().numpy()
    pairs = sorted({tuple(sorted((k, int(x)))) for k in range(edges.shape[0])
                    for x in edges[k] if x >= 0})
    kf_frame = slam.map.kf_frame_id.cpu().numpy()
    pair_frames = [tuple(int(kf_frame[k]) for k in pair) for pair in pairs]
    reached = [c for c in calls if c["reached"]]
    loop = next((c for c in calls if c["closed"]), None)
    detect_ms = [c["ms"] for c in reached if not c["closed"]]
    print(f"circuit: {len(frames) - lost}/{len(frames)} tracked, lost {lost}, n_kf {slam.n_kf}, "
          f"n_pt {slam.n_pt}, loop detection at {len(reached)} keyframes, loop closed at "
          f"{None if loop is None else (loop['kf'], loop['frame'])} (keyframe, frame), "
          f"kf_loop_edges pairs {pairs} made at frames {pair_frames} (the JAX package: "
          f"{JAX_CIRCUIT['loop']} made at frames {JAX_CIRCUIT['loop_frames']}, closed at frame "
          f"{JAX_CIRCUIT['frame']}), gba_runs {slam.stats['gba_runs']}, rigidly aligned ATE "
          f"{ate:.6f} m over {path:.2f} m (bound {CIRCUIT_ATE_BOUND_M:.6f} m from the JAX run's "
          f"{JAX_CIRCUIT['ate']} m, and 1% of the path), paths {slam.stats}")
    for label, t in totals.items():
        print(f"loop stage {label}: {t * 1e3 / counts[label]:.2f} ms per call over "
              f"{counts[label]} calls (synchronized, sync-debug mode on; {card})")
    if parts:
        print("loop correction (_correct_loop, synchronized): " + ", ".join(
            f"{k} {parts[k] * 1e3:.2f} ms" for k in ("propagation", "fuse", "graph",
                                                       "point_correction", "total"))
            + f" ({card})")
    if detect_ms:
        print(f"loop closing per keyframe without a loop (detection, and compute_sim3 where a "
              f"candidate is consistent): median {np.median(detect_ms):.2f} ms, max "
              f"{max(detect_ms):.2f} ms over {len(detect_ms)} keyframes (sync-debug mode on; {card})")
    if loop is not None:
        print(f"loop keyframe {loop['kf']} (frame {loop['frame']}): loop closing "
              f"{loop['ms']:.2f} ms with the GBA (sync-debug mode on; {card}), "
              f"{sum(loop['sites'].values())} host syncs at "
              + ", ".join(f"{k} x{v}" for k, v in sorted(loop["sites"].items()))
              + f"; its launches {loop['launches']}")
    ms = np.asarray(times)
    print(f"circuit frame time: median {np.median(ms):.2f} ms (host clock with synchronize, "
          f"loop-closing frames included; {card}); launches {launches}; peak device memory "
          f"{peak_mib:.1f} MiB ({card})")

    if lost > 2:
        raise AssertionError(f"circuit: {lost} frames lost")
    if len(pairs) != 1 or max(abs(a - b) for a, b in zip(pair_frames[0],
                                                        JAX_CIRCUIT["loop_frames"])) > CIRCUIT_FRAME_TOL:
        raise AssertionError(f"circuit: loop edges {pairs} made at frames {pair_frames}, the JAX "
                             f"package's {JAX_CIRCUIT['loop']} at {JAX_CIRCUIT['loop_frames']}")
    if slam.stats["gba_runs"] < 1:
        raise AssertionError("circuit: no global BA ran")
    if not (ate < CIRCUIT_ATE_BOUND_M and ate < 0.01 * path):
        raise AssertionError(f"circuit: ATE {ate:.6f} m, bound {CIRCUIT_ATE_BOUND_M:.6f} m and "
                             f"{0.01 * path:.3f} m")
    if not np.isfinite(slam.frame_poses()).all():
        raise AssertionError("circuit: non-finite poses")
    return launches


# Phase 11: the orbit frames the loaded map is relocalized on, in
# localization-only mode; the frames after them map on from it.
IO_RELOC_STEPS = range(120, 124)


def _same_map(a, b) -> list:
    """The names of the map banks, counters, vocabulary tensors and database
    banks in which two systems differ."""
    import dataclasses

    from refactored_orb_slam2_tpu_torch.models.map_state import MapState

    diff = [f.name for f in dataclasses.fields(MapState)
            if not torch.equal(getattr(a.map, f.name), getattr(b.map, f.name))]
    diff += [name for name in ("words", "words_pm1", "idf")
             if not torch.equal(getattr(a.vocab, name), getattr(b.vocab, name))]
    diff += [name for name in ("bow", "valid")
             if not torch.equal(getattr(a.db, name), getattr(b.db, name))]
    diff += [name for name in ("n_kf", "n_pt", "ref_kf") if getattr(a, name) != getattr(b, name)]
    if (a.culled_chain.keys() != b.culled_chain.keys()
            or any(not np.array_equal(a.culled_chain[k][0], b.culled_chain[k][0])
                   or a.culled_chain[k][1] != b.culled_chain[k][1] for k in a.culled_chain)):
        diff.append("culled_chain")
    return diff


def _io(slam, frames, poses, device_median_ms: float, card: str) -> dict:
    """Phase 11, I/O and the drivers, on the RGB-D system: save its map,
    load it into a fresh system (every bank equal), relocalize on the loaded
    map in localization-only mode and map on from it; then the dataset
    driver's loop over host copies of the frames on a fresh system, its
    exports read by scripts/evaluate.py, and one pass of the port's bench.
    Returns the launches of 11.3-11.6 (the "io" path)."""
    import io
    import tempfile

    from refactored_orb_slam2_tpu_torch import bench
    from refactored_orb_slam2_tpu_torch.io.checkpoint import load_map, save_map
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.scripts.run_dataset import track_frames
    from refactored_orb_slam2_tpu_torch.system import SlamSystem, TrackState, _write_tum

    cfg, fps = slam.cfg, slam.cfg.camera.fps
    gt = gt_centres(poses)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 11.1 save
        path = os.path.join(tmp, "map.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_map(path, slam)
        save_s = time.perf_counter() - t0
        print(f"io, save: map of n_kf {slam.n_kf}, n_pt {slam.n_pt} (capacity "
              f"{cfg.map.max_keyframes} x {cfg.map.max_points} x {cfg.map.max_obs_per_point}) "
              f"saved in {save_s:.3f} s, file {os.path.getsize(path)} B "
              f"(np.savez_compressed, host clock; {card})")

        # ---- 11.2 load into a fresh system: every bank equal
        loaded = SlamSystem(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_map(path, loaded)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        diff = _same_map(slam, loaded)
        if diff:
            raise AssertionError(f"io: the loaded map differs in {diff}")
        # the host synchronizations of each, once more under sync-debug mode
        syncs = {"save_map": collections.Counter(), "load_map": collections.Counter()}
        with _sync_sites(syncs["save_map"]):
            save_map(os.path.join(tmp, "again.npz"), slam)
        with _sync_sites(syncs["load_map"]):
            load_map(path, SlamSystem(cfg, device="cuda"))
        print(f"io, load: every MapState field, the vocabulary (words, planes, idf), the "
              f"KeyFrameDB (bow, valid), n_kf, n_pt, ref_kf and culled_chain equal to the "
              f"saved system's; loaded in {load_s:.3f} s (host clock with synchronize; {card}); "
              + "; ".join(f"{name}: {sum(c.values())} host syncs" for name, c in syncs.items()))

        # ---- 11.3 relocalize on the loaded map, localization-only mode.  The
        # load leaves the system NOT_INITIALIZED, as the JAX loader does (a
        # fault of the reference, ROADMAP.md: its next frame would start a
        # second map), so the system is set LOST, which is what the JAX
        # docstring's "relocalizes against the loaded map immediately" needs.
        loaded.state = TrackState.LOST
        loaded.activate_localization_mode()
        n_map = (loaded.n_kf, loaded.n_pt)
        cuda_hamming.reset_launches()
        out = []
        for k, i in enumerate(IO_RELOC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(track_device(loaded, frames[i], k))
            torch.cuda.synchronize()
            if k == 0:
                reloc_ms = (time.perf_counter() - t0) * 1e3
                relocs, reloc_launches = loaded.stats["relocs"], dict(cuda_hamming.launches)
        first = IO_RELOC_STEPS[0]
        if out[0] is None or relocs != 1:
            raise AssertionError(f"io: orbit frame {first} did not relocalize on the loaded map "
                                 f"(relocs {relocs}, reloc_rejects "
                                 f"{loaded.stats['reloc_rejects']})")
        err = centre_error(out[0], gt[first])
        if not err < RELOC_BOUND_M["localization"]:
            raise AssertionError(f"io: relocalized centre {err:.6f} m from the rendered one, "
                                 f"bound {RELOC_BOUND_M['localization']:.6f} m")
        if any(p is None for p in out[1:]) or (loaded.n_kf, loaded.n_pt) != n_map:
            raise AssertionError(f"io: after the relocalization {[p is not None for p in out]} "
                                 f"tracked, map {n_map} -> {(loaded.n_kf, loaded.n_pt)}")
        if reloc_launches["window_match"] < 1:
            raise AssertionError("io: no window_match launch on the relocalization frame")
        print(f"io, relocalization on the loaded map (localization-only): orbit frame {first} "
              f"relocalized, centre error {err:.6f} m (bound {RELOC_BOUND_M['localization']} m; "
              f"phase 9's JAX figure {JAX_RELOC['localization'][1]} m), frames "
              f"{IO_RELOC_STEPS[1]}-{IO_RELOC_STEPS[-1]} tracked, n_kf {n_map[0]} and n_pt "
              f"{n_map[1]} unchanged; relocalization frame {reloc_ms:.2f} ms (host clock with "
              f"synchronize; {card}), its launches {reloc_launches}")

        # ---- 11.4 map on from the load
        loaded.deactivate_localization_mode()
        kf_frames, k0 = [], len(IO_RELOC_STEPS)
        for k, i in enumerate(range(IO_RELOC_STEPS[-1] + 1, len(frames))):
            n_kf = loaded.n_kf
            if track_device(loaded, frames[i], k0 + k) is None:
                raise AssertionError(f"io: frame {i} lost while mapping on from the loaded map")
            if loaded.n_kf != n_kf:
                kf_frames.append(i)
        torch.cuda.synchronize()
        print(f"io, mapping on from the loaded map: frames {IO_RELOC_STEPS[-1] + 1}-"
              f"{len(frames) - 1} tracked, keyframes added at frames {kf_frames} "
              f"(n_kf {n_map[0]} -> {loaded.n_kf}, n_pt {n_map[1]} -> {loaded.n_pt})")
        del loaded

        # ---- 11.5 the driver's loop over host frames, through track_rgbd
        host = [(i / fps, img.cpu().numpy(), depth.cpu().numpy())
                for i, (img, depth) in enumerate(frames)]
        driven = SlamSystem(cfg, device="cuda")
        times = track_frames(driven, host, progress=False)
        if len(driven.tracked_logs()) != len(host):
            raise AssertionError(f"io: the driver tracked {len(driven.tracked_logs())} of "
                                 f"{len(host)} host frames")
        files = {name: os.path.join(tmp, name)
                 for name in ("traj.txt", "traj.kitti.txt", "kf.txt", "gt.txt")}
        driven.export_trajectory_tum(files["traj.txt"])
        driven.export_trajectory_kitti(files["traj.kitti.txt"])
        driven.export_keyframe_trajectory_tum(files["kf.txt"])
        # the rendered poses in the first camera's frame, as a TUM file
        _write_tum(files["gt.txt"], [(i / fps, T @ np.linalg.inv(poses[0]))
                                     for i, T in enumerate(poses)])
        lines = {name: len(open(f).read().splitlines()) for name, f in files.items()}
        if lines != {"traj.txt": len(host), "traj.kitti.txt": len(host),
                     "kf.txt": int(driven.map.kf_valid.sum()), "gt.txt": len(host)}:
            raise AssertionError(f"io: exported lines {lines}")
        here = os.path.dirname(os.path.abspath(__file__))
        ev = subprocess.run([sys.executable, os.path.join(here, "scripts", "evaluate.py"),
                             "--est", files["traj.txt"], "--gt", files["gt.txt"], "--json"],
                            capture_output=True, text=True, timeout=120, check=True)
        ate = json.loads(ev.stdout.strip().splitlines()[-1])
        if not (ate["poses"] == len(host) and ate["ate_rmse_m"] < ATE_BOUND_M):
            raise AssertionError(f"io: scripts/evaluate.py gives {ate}, bound {ATE_BOUND_M} m")
        host_ms = np.asarray(times[2:]) * 1e3
        print(f"io, driver loop (track_frames over host frames, track_rgbd): "
              f"{len(driven.tracked_logs())}/{len(host)} tracked, n_kf {driven.n_kf}, n_pt "
              f"{driven.n_pt}; exports {lines}; scripts/evaluate.py ATE "
              f"{ate['ate_rmse_m']:.6f} m (bound {ATE_BOUND_M:.6f} m), RPE {ate['rpe_rmse_m']}; "
              f"median frame {np.median(host_ms):.2f} ms over frames 2-{len(host) - 1} against "
              f"phase 4's device-entry {device_median_ms:.2f} ms (host clock with synchronize; "
              f"{card})")
        del driven

    # ---- 11.6 one pass of the port's bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = bench.main(passes=1)
    line = buf.getvalue().strip().splitlines()[-1]
    if json.loads(line) != result or result["device"] != card:
        raise AssertionError(f"io: the bench printed {line!r}")
    print(f"io, bench (python -m refactored_orb_slam2_tpu_torch.bench, one pass): {line}")
    print(f"io: phase 11 took {time.perf_counter() - t_phase:.1f} s (host clock; {card})")
    return dict(cuda_hamming.launches)


def _kernels(card: str) -> list:
    """Phases 2 and 3: build both kernels, hold each against its plain
    version, time it; returns the rows of the kernel JSON line (without
    the launch counts of the sequence)."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    # ---- 2. build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cuda_hamming.SOURCES)) as pool:
        libs = dict(pool.map(lambda n: (n, cuda_hamming.build([n])[n]),
                             cuda_hamming.SOURCES))
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s (set-up, {len(libs)} nvcc in parallel)")
    for name, log in cuda_hamming.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions
    rng = np.random.default_rng(1)
    band = (-1, 0)
    _window_case(rng, 512, 1024, (60.0, 60.0), band, 1.0)             # self-check
    _, w_err = _window_case(rng, 256, 384, (30.0, 120.0), (-1, 1), 0.9)   # golden
    wargs, err = _window_case(rng, 4096, 1000, (4.0, 20.0), band, 0.9)
    w_err = max(w_err, err)
    m_cases, m_err = {}, 0
    for name in ("fuse", "triangulation", "stereo", "random", "ragged"):
        m_cases[name], err = _masked_check(rng, name)
        m_err = max(m_err, err)
    # the relocalization rescue search (1000 x 1000), from a generator of its
    # own so that the cases above keep their draws
    m_cases["rescue"], err = _masked_check(np.random.default_rng(4), "rescue")
    m_err = max(m_err, err)

    # what a kernel with wide loads, a bank in shared memory and a grid of
    # persistent blocks can get wrong: column counts off every alignment,
    # one row, one column, more rows than one pass of the grid, more columns
    # than one bank, nothing to match, views
    rng = np.random.default_rng(2)
    wfloor, err = _window_case(rng, 1, 1, (700.0, 700.0), band, 1.0)
    w_err = max(w_err, err)
    for n1, n2, radius, p_valid, views in (
            (1, 1000, (40.0, 80.0), 0.9, False), (700, 1, (300.0, 700.0), 0.9, False),
            (300, 7, (100.0, 400.0), 0.9, False), (500, 1001, (20.0, 60.0), 0.9, False),
            (777, 1031, (20.0, 60.0), 0.9, False), (20000, 1000, (4.0, 20.0), 0.9, False),
            (512, 6000, (10.0, 40.0), 0.9, False), (300, 20000, (10.0, 40.0), 0.9, False),
            (900, 1000, (20.0, 60.0), 0.0, False), (640, 1001, (20.0, 60.0), 0.9, True)):
        w_err = max(w_err, _window_case(rng, n1, n2, radius, (-1, 1), p_valid, views)[1])
    mfloor, err = _masked_check(rng, (1, 1, 1.0, "contiguous"))
    m_err = max(m_err, err)
    for case in ((1, 1000, 0.3, "contiguous"), (700, 1, 0.7, "contiguous"),
                 (300, 7, 0.5, "contiguous"), (500, 1001, 0.05, "contiguous"),
                 (20000, 1000, 0.02, "contiguous"), (512, 6000, 0.05, "contiguous"),
                 (600, 9000, 0.3, "contiguous"), (900, 1000, 0.0, "contiguous"),
                 (640, 1001, 0.1, "strided"), (640, 1031, 0.1, "transposed"),
                 (333, 1000, 0.1, "odd offset"), (333, 1013, 0.5, "odd offset")):
        m_err = max(m_err, _masked_check(rng, case)[1])

    # the stereo path's shapes: its preset has other feature slots and another
    # image than the RGB-D and monocular camera, so match_local_points, fuse
    # and the triangulation search launch at sizes of their own (the radius
    # of a local point is 2.5 or 4 px times its level's scale on every sensor)
    rng = np.random.default_rng(3)
    scfg = stereo_config()
    size = dict(n_feat=scfg.orb.n_features, extent=(scfg.camera.width, scfg.camera.height))
    w_stereo, err = _window_case(rng, 4096, size["n_feat"], (2.5, 14.4), band, 0.9,
                                 extent=size["extent"])
    w_err = max(w_err, err)
    for name in ("fuse", "triangulation"):
        m_cases[f"{name}, stereo"], err = _masked_check(rng, name, **size)
        m_err = max(m_err, err)
    m_cases["rescue, stereo"], err = _masked_check(np.random.default_rng(5), "rescue", **size)
    m_err = max(m_err, err)
    # the loop path's shapes on the circuit's camera (320x240, 1000 slots)
    ccfg = circuit_config()
    csize = dict(n_feat=ccfg.orb.n_features, extent=(ccfg.camera.width, ccfg.camera.height))
    for name in ("loop fuse", "projection count"):
        m_cases[name], err = _masked_check(np.random.default_rng(6), name, **csize)
        m_err = max(m_err, err)

    w = {}
    for label, args in (("rgbd", wargs), ("stereo", w_stereo)):
        w[label] = _measure(
            "window_match", f"{args[0].shape[0]}x{args[1].shape[0]}",
            lambda: cuda_hamming.window_match(*args, band),
            lambda: cuda_hamming.window_match_reference(*args, band),
            "window_match_kernel", lambda: cuda_hamming.window_match(*wfloor, band),
            _window_bound(args, band), card)
    m = {}
    for name in ("fuse", "triangulation", "stereo", "fuse, stereo", "triangulation, stereo",
                 "rescue", "rescue, stereo", "loop fuse", "projection count"):
        args = m_cases[name]
        m[name] = _measure(
            "hamming_best2", f"{name} {args[0].shape[0]}x{args[1].shape[0]}",
            lambda: cuda_hamming.hamming_best2(*args),
            lambda: cuda_hamming.hamming_best2_reference(*args),
            "masked_best2_kernel", lambda: cuda_hamming.hamming_best2(*mfloor),
            _masked_bound(args), card)
    return [dict({
        "name": "window_match",
        "route": "cuda",
        "source": "refactored_orb_slam2_tpu_torch/csrc/window_match.cu",
        "replaces": "refactored_orb_slam2_tpu/ops/pallas_hamming.py:193",
        "launches": None,
        "max_abs_err": w_err,
    }, **w["rgbd"], other_shapes=[w["stereo"]]), dict({
        "name": "hamming_best2",
        "route": "cuda",
        "source": "refactored_orb_slam2_tpu_torch/csrc/masked_best2.cu",
        "replaces": "refactored_orb_slam2_tpu/ops/pallas_hamming.py:80",
        "launches": None,
        "max_abs_err": m_err,
    }, **m["fuse"], other_shapes=[m[k] for k in m if k != "fuse"])]


def _launch_rows(kernels: list, by_path: dict, reloc: list) -> None:
    """Each kernel row's launches per path and in all, and phase 9's
    rescue-search comparisons in its error; raises if a kernel was not
    launched on a path that must launch it."""
    # localization-only mode freezes the map, so it has no masked search; a
    # relocalization needs one only for a rescue round or a new keyframe
    exempt = {("localization", "hamming_best2"), ("relocalization", "hamming_best2")}
    for row in kernels:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] == "hamming_best2":     # phase 9's rescue-search comparisons
            row["max_abs_err"] = max([row["max_abs_err"]] + [r["err"] for r in reloc])
        idle = [path for path, n in row["launches_by_path"].items()
                if n == 0 and (path, row["name"]) not in exempt]
        if idle:
            raise AssertionError(f"{row['name']} was not launched on the paths {idle}")


def main(mode: str = "") -> None:
    # ---- 1. device
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; the port runs only on a GPU")
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}")
    # the kernel checks call port functions without a SlamSystem
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    kernels = _kernels(card)
    if mode == "--kernels-only":
        print(json.dumps({"kernels": kernels}))
        print(card)
        return
    if mode == "--circuit-only":
        launches = _circuit(card)
        for row in kernels:
            row["launches"] = launches[row["name"]]
        print(json.dumps({"kernels": kernels}))
        print(card)
        return

    # ---- 4. the RGB-D sequence
    poses = smoke_poses()
    by_path = {}

    def rendered(cfg):
        t0 = time.perf_counter()
        frames = render_frames(cfg, poses, "cuda")
        torch.cuda.synchronize()
        print(f"{cfg.sensor} sequence set-up: {len(frames)} frames "
              f"({cfg.camera.width}x{cfg.camera.height}) rendered on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        return frames

    cfg = rgbd_config()
    frames = rendered(cfg)
    slam, r = _sequence(cfg, frames, poses, ATE_BOUND_M, card)
    by_path["rgbd"] = r["launches"]
    if mode == "--io-only":
        by_path["io"] = _io(slam, frames, poses, r["median_ms"], card)
        _launch_rows(kernels, by_path, [])
        print(json.dumps({"kernels": kernels}))
        print(card)
        return

    # ---- 5. where the time goes
    slam2 = SlamSystem(cfg, device="cuda")
    _breakdown(slam2, frames, r["steady_ms"], r["n_kf"], card)
    del slam2

    # ---- 6. localization-only on the RGB-D system's map
    by_path["localization"] = _localization(slam, frames, card)

    # ---- 9. relocalization: RGB-D, then localization-only, on that system
    reloc = [_relocalization(slam, frames, poses, "rgbd", N_FRAMES + N_LOCALIZATION, card)]
    slam.activate_localization_mode()
    reloc.append(_relocalization(slam, frames, poses, "localization",
                                 N_FRAMES + N_LOCALIZATION + 6, card))
    slam.deactivate_localization_mode()

    # ---- 11. I/O and the drivers: that system's map saved and loaded, the
    # dataset driver's loop, the bench
    by_path["io"] = _io(slam, frames, poses, r["median_ms"], card)
    del slam, frames

    # ---- 7 and 8. the stereo and the monocular sequence, each with phase 9
    for cfg, bound in ((stereo_config(), STEREO_ATE_BOUND_M), (mono_config(), MONO_ATE_BOUND_M)):
        frames = rendered(cfg)
        slam, r = _sequence(cfg, frames, poses, bound, card)
        by_path[cfg.sensor] = r["launches"]
        align = (sim3_alignment(slam.camera_centers(), gt_centres(poses)[slam.tracked_frame_ids()])
                 if cfg.sensor == "monocular" else None)
        reloc.append(_relocalization(slam, frames, poses, cfg.sensor, N_FRAMES, card, align))
        del slam
        stages = SlamSystem(cfg, device="cuda")
        _frame_stages(stages, frames, card)
        del stages, frames

    # ---- 10. the street circuit: a loop closed, corrected and adjusted
    by_path["loop"] = _circuit(card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    by_path["relocalization"] = {name: sum(r["launches"][name] for r in reloc)
                                 for name in by_path["rgbd"]}

    _launch_rows(kernels, by_path, reloc)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    # --kernels-only stops after phase 3: the kernel JSON line (launches
    # null) and the card, without the device line of a whole run;
    # --circuit-only runs phases 1-3 and 10, --io-only phases 1-4 and 11,
    # and each prints the same two lines
    if sys.argv[1:] not in ([], ["--kernels-only"], ["--circuit-only"], ["--io-only"]):
        _fail("usage: python3 chip_smoke.py [--kernels-only | --circuit-only | --io-only] "
              f"(got {sys.argv[1:]})")
    main(sys.argv[1] if sys.argv[1:] else "")
