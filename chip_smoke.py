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
   band like an epipolar one), a random 30%-dense mask (1000 x 1500) and a
   ragged 777 x 1031 case with all-false rows and duplicated descriptors.
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
4. sequence — SlamSystem(device="cuda") at the bench configuration (640x480
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
   keyframe's mapping.

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
    torch.cuda.synchronize()
    dev, _, _ = _trace(lambda: [fn() for _ in range(n)])
    ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in dev if needle in e.name]
    if len(ms) != n:
        raise AssertionError(f"the trace holds {len(ms)} device events named "
                             f"*{needle}* for {n} launches ({len(dev)} device events)")
    return float(np.median(ms))


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


def _window_case(rng, n1, n2, radius_range, band, p_valid, views=False):
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    args = (
        _dev(_words(rng, n1)), _dev(_words(rng, n2)),
        _dev(rng.uniform(0, 640, (n1, 2)).astype(np.float32)),
        _dev(rng.uniform(0, 640, (n2, 2)).astype(np.float32)),
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


def _masked_case(rng, name):
    """(desc_a, desc_b, mask) on the card for the phase-3 shapes."""
    from refactored_orb_slam2_tpu_torch.ops import matching as M

    if name == "fuse":            # projected candidates vs keyframe features
        n1, n2 = 2048, 1000
        uv_a = _dev(rng.uniform(0, 640, (n1, 2)).astype(np.float32))
        uv_b = _dev(rng.uniform(0, 640, (n2, 2)).astype(np.float32))
        radius = _dev((3.0 * 1.2 ** rng.integers(0, 8, n1)).astype(np.float32) * 8)
        oct_a = _dev(rng.integers(0, 8, n1).astype(np.int32))
        oct_b = _dev(rng.integers(0, 8, n2).astype(np.int32))
        mask = M.window_mask(uv_a, uv_b, radius) & M.octave_band_mask(oct_a, oct_b, -1, 1)
        a, b = _words(rng, n1), _words(rng, n2)
    elif name == "triangulation":  # a band like an epipolar one
        n1 = n2 = 1000
        i, j = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
        mask = _dev(np.abs(i * 1.1 - j + rng.integers(-30, 31, (n1, 1))) <= 25)
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


def _masked_check(rng, name):
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    a, b, mask = _masked_case(rng, name)
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
    ("system.SlamSystem", "_build_frame", "frame build (ORB + depth)"),
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


def _breakdown(slam, frames, frame_ms: float, n_kf_expected: int, card: str) -> None:
    """Phase 5 on a fresh system over the same frames."""
    track = lambda i: slam.track_rgbd_device(frames[i][0], frames[i][1], i / 30.0)
    for i in range(4):
        track(i)
    torch.cuda.synchronize()

    totals, n, whole = {}, 4, "whole frame, stages synchronized"
    with _stage_timers(_TRACK_STAGES, totals):
        for i in range(4, 4 + n):
            t0 = time.perf_counter()
            track(i)
            torch.cuda.synchronize()
            totals[whole] = totals.get(whole, 0.0) + time.perf_counter() - t0
    for label, t in totals.items():
        print(f"stage {label}: {t / n * 1e3:.2f} ms/frame (frames 4-7; {card})")

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


def _sequence(cfg, frames, poses):
    """Phase 4: track every frame, with the per-keyframe checks."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    slam = SlamSystem(cfg, device="cuda")
    slam.loop_closing_enabled = False
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
    times, out, kf_frames = [], [], []
    cuda_hamming.reset_launches()
    for i, (img, depth) in enumerate(frames):
        n_kf = slam.n_kf
        t0 = time.perf_counter()
        pose = slam.track_rgbd_device(img, depth, i / 30.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append(pose)
        if slam.n_kf != n_kf:
            kf_frames.append(i)
    launches = dict(cuda_hamming.launches)
    torch.cuda.synchronize()

    n = len(frames)
    n_tracked = sum(p is not None for p in out)
    est = slam.frame_poses()
    if n_tracked != n or est.shape != (n, 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"tracked {n_tracked}/{n} frames, poses {est.shape}")
    if slam.n_kf < 3:
        raise AssertionError(f"n_kf = {slam.n_kf}, expected >= 3")
    if not ba or not tri or max(tri) <= 0:
        raise AssertionError(f"local BAs {ba}, points triangulated per keyframe {tri}")
    if [k for k, _, _ in mapped] != list(range(1, slam.n_kf)):
        raise AssertionError(f"mapped keyframes {[k for k, _, _ in mapped]}")
    if min(m for _, _, m in mapped) < 1:
        raise AssertionError(f"masked-kernel launches per keyframe {[m for *_, m in mapped]}")
    if launches["window_match"] < n - 1:
        raise AssertionError(f"window_match launched {launches['window_match']} "
                             f"times in {n - 1} tracked frames")
    centres = slam.camera_centers()
    gt = np.stack([(poses[0] @ np.linalg.inv(T))[:3, 3] for T in poses])
    ate = float(np.sqrt(np.mean(np.sum((centres - gt) ** 2, axis=1))))
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"ATE {ate:.6f} m >= bound {ATE_BOUND_M:.6f} m")
    return slam, dict(times=times, kf_frames=kf_frames, mapped=mapped, tri=tri,
                      ba=ba, launches=launches, ate=ate)


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
    for name in ("fuse", "triangulation", "random", "ragged"):
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

    w = _measure(
        "window_match", "4096x1000",
        lambda: cuda_hamming.window_match(*wargs, band),
        lambda: cuda_hamming.window_match_reference(*wargs, band),
        "window_match_kernel", lambda: cuda_hamming.window_match(*wfloor, band),
        _window_bound(wargs, band), card)
    m = {}
    for name in ("fuse", "triangulation"):
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
    }, **w), dict({
        "name": "hamming_best2",
        "route": "cuda",
        "source": "refactored_orb_slam2_tpu_torch/csrc/masked_best2.cu",
        "replaces": "refactored_orb_slam2_tpu/ops/pallas_hamming.py:80",
        "launches": None,
        "max_abs_err": m_err,
    }, **m["fuse"], other_shapes=[m["triangulation"]])]


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
    from refactored_orb_slam2_tpu_torch.utils import world3d as W
    from refactored_orb_slam2_tpu_torch.geometry.camera import camera_from_config
    from refactored_orb_slam2_tpu_torch.config import (
        CameraConfig, MapConfig, ORBConfig, SystemConfig,
    )

    kernels = _kernels(card)
    if kernels_only:
        print(json.dumps({"kernels": kernels}))
        print(card)
        return

    # ---- 4. the sequence
    H, Wd = 480, 640
    cfg = SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0,
                            width=Wd, height=H, fps=30),
        orb=ORBConfig(n_features=1000, n_levels=8),
        map=MapConfig(max_keyframes=512, max_points=65536, max_obs_per_point=32),
    )
    t0 = time.perf_counter()
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:N_FRAMES]
    frng = np.random.default_rng(0)
    cam = camera_from_config(cfg.camera)
    frames = [world.render_device(T, cam, want_depth=True, noise=2.0, rng=frng,
                                  device="cuda") for T in poses]
    torch.cuda.synchronize()
    print(f"sequence set-up: {len(frames)} frames rendered on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    slam, r = _sequence(cfg, frames, poses)
    times = np.asarray(r["times"]) * 1e3
    kf_mask = np.zeros(len(times), bool)
    kf_mask[r["kf_frames"]] = True
    steady = ~kf_mask
    steady[:2] = False
    culled = sorted(slam.culled_chain)
    map_ms = [t * 1e3 for _, t, _ in r["mapped"]]
    print(f"sequence: {len(frames)}/{len(frames)} tracked, lost 0, n_kf {slam.n_kf}, "
          f"n_pt {slam.n_pt}, keyframe frames {r['kf_frames']}, culled keyframes "
          f"{culled}, ATE {r['ate']:.6f} m (bound {ATE_BOUND_M:.6f} m from the "
          f"JAX run's {JAX_ATE_M} m)")
    print(f"sequence mapping: local BAs at n_kf {r['ba']}, points triangulated per "
          f"keyframe {r['tri']}, masked-kernel launches per keyframe "
          f"{[m for *_, m in r['mapped']]}, launches {r['launches']}")
    print(f"sequence frame time: median {np.median(times[2:]):.2f} ms over frames "
          f"2-{len(times) - 1}; without keyframe frames {np.median(times[steady]):.2f} ms; "
          f"keyframe frames median {np.median(times[kf_mask]):.2f} ms "
          f"(host clock with synchronize; {card})")
    print(f"sequence mapping time per keyframe (synchronized): median "
          f"{np.median(map_ms):.2f} ms, each " + " ".join(f"{t:.2f}" for t in map_ms)
          + f" ms ({card})")
    print("per-frame ms: " + " ".join(f"{t:.2f}" for t in times))
    print(f"sequence peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # ---- 5. where the time goes
    slam2 = SlamSystem(cfg, device="cuda")
    slam2.loop_closing_enabled = False
    _breakdown(slam2, frames, float(np.median(times[steady])), slam.n_kf, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    for row in kernels:
        row["launches"] = r["launches"][row["name"]]
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
