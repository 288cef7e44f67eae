"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
   stereo_match), a random 30%-dense mask (1000 x 1500) and a ragged
   777 x 1031 case with all-false rows and duplicated descriptors.
   Then both at the shapes wide loads and persistent grids can get wrong:
   column counts off every alignment, one row, one column, 20000 rows,
   6000 to 20000 columns, nothing to match, strided, transposed and
   odd-offset views.  Then the times at the tracking shape and at the fuse
   and triangulation shapes: the kernel's own duration on the device (from
   a torch.profiler trace, median of 20 launches), the same at N1 = N2 = 1
   (what any launch costs), the bound computed from the inputs (bytes over
   the memory rate or operations over the non-tensor rate, whichever is
   larger) with the kernel's share of it, and CUDA-event medians around the
   wrapper and the plain version, interleaved (what a caller waits);
4. RGB-D sequence — SlamSystem(device="cuda") at the bench configuration (640x480
   RGB-D, TUM fr1 intrinsics, 1000 ORB features, 8 levels, map 512
   keyframes x 65536 points x 32 observations), synchronous mapping, loop
   closing off, tracks all 160 frames of the bench room-orbit trajectory,
   rendered on the card.  Asserts no frame lost, n_kf >= 3, a local BA and
   a triangulation that created points, a window-kernel launch per tracked
   frame and a masked-kernel launch per keyframe after the first, and the
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
   points triangulated at every mapped keyframe, and the Sim3-aligned ATE
   bound MONO_ATE_BOUND_M from the JAX package's run; prints the host
   synchronizations of the accepted initialization attempt.

Phases 7 and 8 also print the synchronized stage times of a tracked frame
on a second system (frames 4-7 after the first tracked one).  Every path is
driven with the kernels' launch counts set to 0 just before it and read
just after.  ``tests/test_torch_smoke_reference.py`` (marked slow) runs the
JAX package on the CPU over the same frames and holds the three JAX_*
constants below to what it gives.

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


def ate_rmse_sim3(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE after a similarity alignment (Umeyama), for monocular runs whose
    scale and frame are free."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(E))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    scale = np.trace(np.diag(D) @ S) / max((E ** 2).sum() / len(E), 1e-12)
    return ate_rmse(scale * E @ (U @ S @ Vt).T + mu_g, gt)


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
    # a trace now and then lacks one launch's event (seen once in some
    # fifty traces on an H100): such a trace is taken again, twice at most
    for attempt in range(3):
        torch.cuda.synchronize()
        dev, _, _ = _trace(lambda: [fn() for _ in range(n)])
        ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in dev if needle in e.name]
        if len(ms) == n:
            return float(np.median(ms))
        print(f"trace {attempt + 1} holds {len(ms)} device events named *{needle}* for "
              f"{n} launches ({len(dev)} device events)")
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
def _stage_timers(stages, totals: dict):
    """Wrap ``stages`` with a synchronize on each side and add each call's
    host-clock time to ``totals[label]``; restore on exit."""
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
    slam.loop_closing_enabled = False
    mono = cfg.sensor == "monocular"
    mapped, tri, ba = [], [], []
    steps, reconcile, local_ba = (slam._mapping_steps, slam._reconcile_triangulation,
                                  slam._windowed_ba)

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

    slam._mapping_steps = timed_steps
    slam._reconcile_triangulation = counted_reconcile
    slam._windowed_ba = counted_ba

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
    if mono:
        print(f"monocular initialization accepted at frame {first}: "
              f"{sum(init_sites.values())} host syncs in that frame at "
              + ", ".join(f"{k} x{v}" for k, v in sorted(init_sites.items())))
    return slam, dict(launches=launches, n_kf=slam.n_kf,
                      steady_ms=float(np.median(ms[steady])))


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

    w = {}
    for label, args in (("rgbd", wargs), ("stereo", w_stereo)):
        w[label] = _measure(
            "window_match", f"{args[0].shape[0]}x{args[1].shape[0]}",
            lambda: cuda_hamming.window_match(*args, band),
            lambda: cuda_hamming.window_match_reference(*args, band),
            "window_match_kernel", lambda: cuda_hamming.window_match(*wfloor, band),
            _window_bound(args, band), card)
    m = {}
    for name in ("fuse", "triangulation", "stereo", "fuse, stereo", "triangulation, stereo"):
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


def main(kernels_only: bool = False) -> None:
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
    if kernels_only:
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

    # ---- 5. where the time goes
    slam2 = SlamSystem(cfg, device="cuda")
    slam2.loop_closing_enabled = False
    _breakdown(slam2, frames, r["steady_ms"], r["n_kf"], card)
    del slam2

    # ---- 6. localization-only on the RGB-D system's map
    by_path["localization"] = _localization(slam, frames, card)
    del slam, frames

    # ---- 7 and 8. the stereo and the monocular sequence
    for cfg, bound in ((stereo_config(), STEREO_ATE_BOUND_M), (mono_config(), MONO_ATE_BOUND_M)):
        frames = rendered(cfg)
        _, r = _sequence(cfg, frames, poses, bound, card)
        by_path[cfg.sensor] = r["launches"]
        stages = SlamSystem(cfg, device="cuda")
        stages.loop_closing_enabled = False
        _frame_stages(stages, frames, card)
        del stages, frames
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # localization-only mode freezes the map, so it has no masked search
    for row in kernels:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        idle = [path for path, n in row["launches_by_path"].items()
                if n == 0 and (path, row["name"]) != ("localization", "hamming_best2")]
        if idle:
            raise AssertionError(f"{row['name']} was not launched on the paths {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    # --kernels-only stops after phase 3: the kernel JSON line (launches
    # null) and the card, without the device line of a whole run
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        _fail(f"usage: python3 chip_smoke.py [--kernels-only] (got {sys.argv[1:]})")
    main(kernels_only=bool(sys.argv[1:]))
