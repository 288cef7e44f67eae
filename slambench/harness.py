"""One run of a cell: set-up, the measured window, the reference's verdict.

Set-up (``setup_s``, from the process's start): the configuration, the
kernels built or loaded and held once against the plain best-2, the cell's
frames rendered on the device from its traffic file, the system made and
driven over the first ``warmup_frames`` frames of its own sequence (the
tracked frame's CUDA graph is captured there, and at least one keyframe is
mapped), its pipeline flushed and its mapping drained.

The window: passes over the cell's sequence, each on a fresh map
(``reset()``, counted into the pass's first frame).  Each frame goes in
through the sensor's entry (``SENSORS``) as soon as the previous call has
returned and the caller's stream is synchronized; its time is that call's,
on the host clock.  At the end of a pass,
``flush_pipeline()`` and the drain of mapping count into its last frame.
The window closes at the first return past ``--seconds`` of the calls'
summed time; the harness's own bookkeeping between calls is outside it.

After the window the system is freed and ``reference.py`` judges what each
pass left: its frames lost or never logged, its trajectory, its keyframes
and map points, and the matchers' answers on calls sampled from the seed
(every call in a traced slice).  A monocular pass returns no pose until its
initializer accepts a frame pair: the frames fed before its first tracked
frame are its ``init_frames``, and only the frames from that one on count
as lost; its map has the initializer's unit, so it is aligned to the ground
truth by a similarity.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from . import reference, tracing, work
from .registry import HERE, metric_reader
from .world import load_scene, load_trajectory

CHECKS_DIR = HERE / "checks"


# ------------------------------------------------------------------ inputs
def build_config(doc: dict):
    """The port's ``SystemConfig`` from a configuration file's ``system``."""
    from refactored_orb_slam2_tpu_torch import config as C

    s = doc["system"]
    groups = dict(camera=C.CameraConfig, orb=C.ORBConfig, matcher=C.MatcherConfig,
                  tracking=C.TrackingConfig, map=C.MapConfig, loop=C.LoopConfig)
    flat = {k: v for k, v in s.items() if k not in groups}
    return C.SystemConfig(**flat, **{k: cls(**s[k]) for k, cls in groups.items()})


#: per sensor of the configuration: the port's entry for frames on the
#: device, and a frame's arguments to it, rendered from a pose
SENSORS = {
    "rgbd": ("track_rgbd_device", lambda world, T, cam, noise, gen, device:
             world.render_device(T, cam, noise, gen, device, want_depth=True)),
    "stereo": ("track_stereo_device", lambda world, T, cam, noise, gen, device:
               world.render_stereo_device(T, cam, noise, gen, device)),
    "monocular": ("track_monocular_device", lambda world, T, cam, noise, gen, device:
                  (world.render_device(T, cam, noise, gen, device),)),
}


def make_inputs(traffic: dict, cfg, device) -> dict:
    """The cell's frames on ``device`` in the wire encoding, their ground
    truth (Tcw, timestamps) and the scene's surfaces: the traffic file's
    scene and the first ``first`` poses of its trajectory (files under
    ``scenes/`` and ``trajectories/``), with the sensor noise of its
    ``noise_seed``, the same in every run.  A run's seed draws which answers
    are checked, not the frames: the noise decides the keyframes, and with
    them the error of a whole pass (on an H100, desk orbit ATE 1.30-2.22 mm
    over nine noise seeds, 1.70-1.73 mm over three runs of one; PERF.md)."""
    world = load_scene(traffic["scene"])
    poses = load_trajectory(traffic["trajectory"])[:traffic["first"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic["noise_seed"])
    cam, noise = cfg.camera, traffic["noise"]
    render = SENSORS[cfg.sensor][1]
    frames = [render(world, T, cam, noise, gen, device) for T in poses]
    return dict(frames=frames, Tcw=poses, stamps=np.arange(len(poses)) / cam.fps,
                surfaces=world.surfaces)


def kernel_selfcheck(cfg, device) -> None:
    """Each matcher once on random inputs at the tracking shape (4096 x the
    feature count) against the plain best-2 (the pattern of the port's
    ``bench.py``); building the kernels is part of it.  Raises on any
    difference."""
    from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

    g = torch.Generator(device="cpu").manual_seed(0)
    w, h, nf, nl = cfg.camera.width, cfg.camera.height, cfg.orb.n_features, cfg.orb.n_levels
    words = lambda n: torch.randint(-2**31, 2**31, (n, 8), generator=g,
                                    dtype=torch.int64).to(torch.int32)
    uv = lambda n: torch.rand((n, 2), generator=g) * torch.tensor([w, h])
    octs = lambda n: torch.randint(0, nl, (n,), generator=g, dtype=torch.int32)
    n1 = 4096
    args = (words(n1), words(nf), uv(n1), uv(nf), 4.0 + 16.0 * torch.rand(n1, generator=g),
            octs(n1), octs(nf), torch.rand(n1, generator=g) < 0.9,
            torch.rand(nf, generator=g) < 0.9)
    calls = [dict(name="window_match", band=(-1, 0), args=args,
                  out=cuda_hamming.window_match(*(a.to(device) for a in args), (-1, 0)))]
    mask = torch.rand((2048, nf), generator=g) < 0.02
    args = (words(2048), words(nf), mask)
    calls.append(dict(name="hamming_best2", band=None, args=args,
                      out=cuda_hamming.hamming_best2(*(a.to(device) for a in args))))
    for c in calls:
        c["args"] = [a.numpy() for a in c["args"]]
        c["out"] = [o.cpu().numpy() for o in c["out"]]
        if reference.wrong_rows(c):
            raise RuntimeError(f"{c['name']} differs from the plain best-2 on random inputs")


# ------------------------------------------------------------ the recorder
class Recorder:
    """Wrappers around the port's matchers and its CUDA graph's ``run``.

    - A matcher call made while the graph is captured keeps its tensors
      (``slots``): every replay writes that call's inputs and output there.
    - ``take``: after the next replay, copy every slot (graph calls), and
      copy each eager call whose ordinal per matcher is in ``eager_ordinals``
      or every eager call while ``take_all`` is set; ``calls`` holds the
      copies in launch order.
    - ``events``: CUDA events around each replay (traced runs)."""

    def __init__(self, device):
        from refactored_orb_slam2_tpu_torch.frontend.fused_graph import FusedGraph
        from refactored_orb_slam2_tpu_torch.ops import cuda_hamming

        self.device = device
        self.mod, self.graph_cls = cuda_hamming, FusedGraph
        self.slots, self.calls, self.event_pairs = [], [], []
        self.eager_seen = {"window_match": 0, "hamming_best2": 0}
        self.eager_ordinals: set = set()
        self.take = self.take_all = self.events = False
        self.calls_before = 0
        self._saved = None

    @staticmethod
    def _copy(name, band, args, out):
        return dict(name=name, band=band, args=[a.clone() for a in args],
                    out=[o.clone() for o in out])

    def _seen(self, name, band, args, out):
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            self.slots.append(dict(name=name, band=band, args=args, out=out))
            return
        k = self.eager_seen[name]
        self.eager_seen[name] += 1
        if self.take_all or (name, k) in self.eager_ordinals:
            self.calls.append(self._copy(name, band, args, out))

    def install(self):
        mod, cls = self.mod, self.graph_cls
        self._saved = (mod.window_match, mod.hamming_best2, cls.run)
        window_match, hamming_best2, run = self._saved
        rec = self

        def window_match_recorded(desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t,
                                  valid_q, valid_t, oct_band):
            args = (desc_q, desc_t, uv_q, uv_t, radius, oct_q, oct_t, valid_q, valid_t)
            out = window_match(*args, oct_band)
            rec._seen("window_match", (int(oct_band[0]), int(oct_band[1])), args, out)
            return out

        def hamming_best2_recorded(desc_a, desc_b, mask):
            out = hamming_best2(desc_a, desc_b, mask)
            rec._seen("hamming_best2", None, (desc_a, desc_b, mask), out)
            return out

        def run_recorded(graph, inputs):
            if graph.graph is None:
                return run(graph, inputs)
            if rec.events:
                pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                pair[0].record()
            out = run(graph, inputs)
            if rec.events:
                pair[1].record()
                rec.event_pairs.append(pair)
            if rec.take or rec.take_all:
                rec.calls += [rec._copy(s["name"], s["band"], s["args"], s["out"])
                              for s in rec.slots]
                rec.take = False
            return out

        mod.window_match, mod.hamming_best2 = window_match_recorded, hamming_best2_recorded
        cls.run = run_recorded

    def uninstall(self):
        if self._saved is not None:
            self.mod.window_match, self.mod.hamming_best2, self.graph_cls.run = self._saved
            self._saved = None


# ------------------------------------------------------------------- a run
def _snapshot(slam, fps: float, fed: int, init: int | None, complete: bool) -> dict:
    """What a pass left, on the host: its tracked frames' timestamps and
    poses, its lost frames, its valid keyframes (the frame each was made
    from, its pose) and its valid map points; the frames fed, and ``init``,
    the frames fed before the first call that returned a pose (all of them
    when none did)."""
    logs = slam.tracked_logs()
    Tcw = slam.frame_poses()
    m = slam.map
    n_kf = slam.n_kf
    kf_valid = m.kf_valid[:n_kf].cpu().numpy()
    kf_pose = m.kf_pose[:n_kf].cpu().numpy()
    first = {}
    for log in slam.trajectory:
        if not log.lost:
            first.setdefault(log.ref_kf, int(round(log.timestamp * fps)))
    kfs = [k for k in range(n_kf) if kf_valid[k] and k in first]
    return dict(ts=np.asarray([log.timestamp for log in logs]), Tcw=Tcw,
                lost=sum(log.lost for log in slam.trajectory),
                logged=len(slam.trajectory), n_kf=n_kf,
                kf_frame=np.asarray([first[k] for k in kfs], int),
                kf_Tcw=kf_pose[kfs].reshape(-1, 4, 4),
                points=m.pt_pos[m.pt_valid].cpu().numpy(),
                fed=fed, init=fed if init is None else init, complete=complete)


def _card() -> str:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def drive(spec: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
          t_start: float | None = None, log=sys.stderr) -> dict:
    """Set-up and the window of one run of the cell ``spec``
    (``registry.cell``), with the system freed after it: every frame's
    time, what each pass left (``_snapshot``), the checked matcher calls on
    the host, the inputs' ground truth, ``setup_s``, the traced run's
    readings, the device's memory peak and the system's ``stats``."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.current_stream(device).synchronize if on_card else (lambda: None)
    say = lambda *a: print(*a, file=log, flush=True)
    from refactored_orb_slam2_tpu_torch.system import SlamSystem

    cfg = build_config(spec["config"])
    traffic, name = spec["traffic"], spec["workload"]["name"]
    fps = cfg.camera.fps
    marks = [("imports", time.perf_counter())]
    if on_card:
        kernel_selfcheck(cfg, device)
    marks.append(("kernels", time.perf_counter()))
    inputs = make_inputs(traffic, cfg, device)
    sync()
    marks.append(("render", time.perf_counter()))
    frames = inputs.pop("frames")

    rec = Recorder(device)
    rec.install()
    probes = None
    try:
        slam = SlamSystem(cfg, device=device, **spec["config"]["mode"])
        feed = getattr(slam, SENSORS[cfg.sensor][0])
        for i in range(traffic["warmup_frames"]):
            feed(*frames[i], i / fps)
        slam.flush_pipeline()
        slam.wait_mapping_idle(timeout=300)
        sync()
        # what the window checks: the replays at (or after) frames drawn from
        # the seed among a pass's first ones, which every window reaches, and
        # eager matcher calls by ordinal
        rng = np.random.default_rng(seed)
        n = len(frames)
        replays = traffic["checked_frames"]
        checked_frames = set(rng.choice(replays["among_first"], replays["count"],
                                        replace=False).tolist())
        eager = traffic["checked_eager_calls"]
        rec.eager_ordinals = {(k, int(o)) for k in rec.eager_seen
                              for o in rng.choice(eager["among_first"], eager["count"],
                                                  replace=False)}
        rec.eager_seen = dict.fromkeys(rec.eager_seen, 0)
        rec.calls.clear()
        probes = _Probes(slam, rec, sync, traffic["trace_frames"]) if trace else None
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        steps = ", ".join(f"{label} {t - t_prev:.2f}" for (label, t), t_prev
                          in zip(marks, [t_start] + [t for _, t in marks]))
        say(f"set-up {setup_s:.2f} s ({steps}): {n} frames of {name} rendered (seed {seed}), "
            f"{traffic['warmup_frames']} warm-up frames, {slam.n_kf} keyframes mapped")

        times, passes, elapsed = [], [], 0.0
        if probes is not None:
            probes.open_window()
        while elapsed < seconds:
            t0 = time.perf_counter()
            slam.reset()
            sync()
            t_reset = time.perf_counter() - t0
            k, init = 0, None
            for k in range(n):
                if k in checked_frames and not passes:
                    rec.take = True     # until the next replay
                in_slice = probes is not None and probes.frame_starts(k)
                t0 = time.perf_counter()
                with (torch.profiler.record_function(tracing.FRAME) if in_slice
                      else nullcontext()):
                    pose = feed(*frames[k], k / fps)
                    sync()
                dt = time.perf_counter() - t0 + (t_reset if k == 0 else 0.0)
                if init is None and pose is not None:
                    init = k
                if probes is not None:
                    probes.frame_ends(k, slam.frame_id)
                times.append(dt)
                elapsed += dt
                if elapsed >= seconds:
                    break
            t0 = time.perf_counter()
            slam.flush_pipeline()
            slam.wait_mapping_idle(timeout=300)
            sync()
            t_flush = time.perf_counter() - t0
            if k == n - 1:
                times[-1] += t_flush
                elapsed += t_flush
            passes.append(_snapshot(slam, fps, k + 1, init, k == n - 1))
            p = passes[-1]
            say(f"pass {len(passes)}: {k + 1} frames, {p['init']} before the first pose, "
                f"{p['lost']} lost, {p['fed'] - p['logged']} not logged, {p['n_kf']} keyframes, "
                f"{len(p['points'])} points, {sum(times[-(k + 1):]):.3f} s "
                f"(reset {t_reset:.3f} s, flush and drain {t_flush:.3f} s)")
        readings = probes.finish() if probes is not None else None
        if readings is not None:
            readings["frame_s"] = list(times)
            say(f"traced window: {len(readings['spans'])} span records "
                f"(the port keeps at most {readings['span_limit']})")
        memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        calls = [dict(name=c["name"], band=c["band"],
                      args=[a.cpu().numpy() for a in c["args"]],
                      out=[o.cpu().numpy() for o in c["out"]]) for c in rec.calls]
        stats = dict(slam.stats)
        del slam, feed, frames
    finally:
        rec.uninstall()
        if probes is not None:
            probes.telemetry.tracing(False)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(times=times, passes=passes, inputs=inputs, calls=calls, setup_s=setup_s,
                readings=readings, memory_peak=int(memory_peak), stats=stats,
                on_card=on_card, device=device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, log=sys.stderr) -> dict:
    """One run of the cell ``spec``: ``drive``, then the reference's
    verdict; returns the result line's object.  ``device`` is the card, or
    the CPU for the tests' tiny cell."""
    run = drive(spec, seed, seconds, trace, device=device, t_start=t_start, log=log)
    passes, readings, device = run["passes"], run["readings"], run["device"]
    sensor = spec["config"]["system"]["sensor"]
    verdict = judge(passes, run["inputs"], run["calls"], spec["workload"]["name"], sensor)
    result = dict(correct=verdict["correct"], attempted=len(run["times"]),
                  failed=failed_frames(passes, sensor))
    if trace:
        result["metrics"] = layer_metrics(spec["per_layer"], readings)
    else:
        e2e = dict(window_metrics(run["times"]), ate_mm=verdict["ate_mm"],
                   setup_s=run["setup_s"])
        result["metrics"] = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                             for m in spec["end_to_end"]}
    on_card = run["on_card"]
    result["device"] = dict(platform="gpu" if on_card else "cpu",
                            kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                            count=1, memory_peak_bytes=run["memory_peak"])
    if on_card:
        result["device"]["card"] = _card()
    if trace and readings and readings.get("slice"):
        sl = readings["slice"]
        result["device"].update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        result["breakdown"] = dict(device_ops=sl["device_ops"], idle_gaps=sl["idle_gaps"])
    result["readings"] = dict(passes=len(passes), stats=run["stats"], **verdict["readings"])
    if trace and readings:
        result["readings"].update(span_records=len(readings["spans"]),
                                  span_limit=readings["span_limit"])
    result["checks"] = verdict["checks"]
    return result


def _posed_from(p: dict, sensor: str) -> int:
    """The frame of a pass from which every frame fed should come back with
    a pose: a monocular pass's first tracked frame, else its first."""
    return p.get("init", 0) if sensor == "monocular" else 0


def failed_frames(passes, sensor: str) -> int:
    """The result's ``failed``: frames fed that came back with no pose (lost,
    or never logged), from each pass's ``_posed_from`` on."""
    return int(sum(p["lost"] + max(0, p["fed"] - _posed_from(p, sensor) - p["logged"])
                   for p in passes))


def window_metrics(times) -> dict:
    """The window's rate and frame-time percentiles, over every frame's
    call time (seconds): frames over the window's summed time, and the
    50th and 95th percentiles of all frames, in ms."""
    t = np.asarray(times, np.float64)
    return dict(frames_per_s=float(len(t) / t.sum()),
                frame_p50_ms=float(np.percentile(t, 50)) * 1e3,
                frame_p95_ms=float(np.percentile(t, 95)) * 1e3)


# ------------------------------------------------------------- traced runs
class _Probes:
    """What a traced run adds: CUDA events around each replay, a keyframe's
    mapping timed with the stream synchronized around each step (outside
    the profiled slice, whose keyframes are left out of it), the profiled
    slice itself, taken again in a later pass when the profiler lost the
    matchers' launches, and the port's own spans and counters over the
    window (``telemetry.tracing`` on from its first frame to its close),
    with each frame's id and host stamps on the spans' clock."""

    def __init__(self, slam, rec, sync, trace_frames):
        from refactored_orb_slam2_tpu_torch.utils import telemetry

        self.telemetry = telemetry
        self.rec, self.sync = rec, sync
        self.start, self.stop = trace_frames
        self.prof = self.slice = None
        self.slice_calls: list = []
        self.in_slice = False
        self.mapped_s: list = []
        self.frame_stamps: list = []
        self.counters0: dict = {}
        self.t_frame = 0
        rec.events = True
        steps = slam._coop_steps
        probes = self

        def timed_steps(kf_slot):
            gen, total, clean = steps(kf_slot), 0.0, True
            while True:
                timed = not probes.in_slice
                clean &= timed
                if timed:
                    sync()
                t0 = time.perf_counter()
                with torch.profiler.record_function("slambench.mapping"):
                    try:
                        next(gen)
                        done = False
                    except StopIteration:
                        done = True
                if timed:
                    sync()
                total += time.perf_counter() - t0
                if done:
                    break
                yield
            if clean:
                probes.mapped_s.append(total)

        slam._coop_steps = timed_steps
        for method in ("_dispatch_fused", "_commit_fused", "flush_pipeline", "reset"):
            slam.__dict__[method] = _spanned(getattr(slam, method), "slambench." + method.strip("_"))

    def open_window(self) -> None:
        """Spans from here to ``finish``: the set-up's records dropped."""
        self.telemetry.spans()
        self.counters0 = self.telemetry.snapshot()["counters"]
        self.telemetry.tracing(True)

    def frame_starts(self, k: int) -> bool:
        self.t_frame = time.time_ns()
        if self.slice is not None or not self.start <= k < self.stop:
            return False
        if k == self.start:
            self.rec.calls_before = len(self.rec.calls)
            self.rec.take_all = True
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.rec.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.in_slice = True
        return True

    def frame_ends(self, k: int, frame_id: int) -> None:
        self.frame_stamps.append((frame_id, self.t_frame, time.time_ns()))
        if not self.in_slice or k != self.stop - 1:
            return
        self.in_slice = False
        self.rec.take_all = False
        self.prof.__exit__(None, None, None)
        got = tracing.read_slice(self.prof)
        calls = self.rec.calls[self.rec.calls_before:]
        self.prof = None
        if got is None or any(len(got["launches"].get(key, [])) !=
                              sum(c["name"] == key for c in calls)
                              for key in tracing.KERNELS):
            return                      # taken again in the next pass
        self.slice, self.slice_calls = got, calls

    def finish(self) -> dict:
        """The readings, once the window has closed; tracing is off again."""
        tel = self.telemetry
        tel.tracing(False)
        spans = tel.spans()
        before = self.counters0
        counters = {k: v - before.get(k, 0) for k, v in tel.snapshot()["counters"].items()
                    if v != before.get(k, 0)}
        if self.prof is not None:       # the window closed inside the slice
            self.prof.__exit__(None, None, None)
        self.sync()
        graph_ms = [a.elapsed_time(b) for a, b in self.rec.event_pairs]
        return dict(graph_ms=graph_ms, mapped_s=self.mapped_s, slice=self.slice,
                    slice_calls=self.slice_calls, spans=spans, span_limit=tel.MAX_SPANS,
                    counters=counters, frame_stamps=self.frame_stamps)


def _spanned(fn, label):
    def spanned(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return spanned


def layer_metrics(entries, readings) -> dict:
    """Each per-layer metric's reader on the traced run's readings; a
    reader that finds nothing leaves its metric out."""
    r = dict(readings or {})
    r["slice_least"] = {}
    for c in (r.get("slice_calls") or []):
        host = dict(name=c["name"], band=c["band"], args=[a.cpu().numpy() for a in c["args"]])
        r["slice_least"].setdefault(c["name"], []).append(work.least_seconds(host))
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(r)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


# ---------------------------------------------------------------- verdict
def judge(passes, inputs, calls, workload, sensor: str = "rgbd") -> dict:
    """The reference's readings over every pass and every checked call, and
    each compared number against its limit (``checks/<workload>.json``).
    ``sensor`` is the configuration's: a monocular pass is aligned by a
    similarity and counts its lost frames from its first tracked frame."""
    mono = sensor == "monocular"
    judged = [reference.judge_pass(p, inputs["Tcw"], inputs["stamps"], inputs["surfaces"],
                                   with_scale=mono)
              for p in passes]
    sq = np.concatenate([j["sq_err"] for j in judged]) if judged else np.zeros(0)
    rms = lambda x: float(np.sqrt(np.mean(np.square(x)))) * 1e3 if len(x) else float("inf")
    # the numbers compared read whole passes: a pass the window cut holds
    # only the sequence's first frames and the map they made
    whole = ([(j, p) for j, p in zip(judged, passes) if p["complete"]]
             or list(zip(judged, passes)))
    full = [j for j, _ in whole]
    pass_ate = [rms(np.sqrt(j["sq_err"])) for j in full]
    readings = dict(
        # frames fed in a whole pass that came back with no pose (lost, or
        # never logged), from its first frame on (a monocular pass: from its
        # first tracked frame on), worst pass
        lost_frames=max(p["fed"] - _posed_from(p, sensor) - p["logged"] + p["lost"]
                        for _, p in whole),
        ate_mm=float(np.sqrt(sq.mean())) * 1e3 if len(sq) else float("inf"),
        worst_pass_ate_mm=max(pass_ate),
        rpe_mm=max(rms(j["rpe"]) for j in full),
        kf_mm=max(rms(j["kf_err"]) for j in full),
        pt_mm=max(float(np.median(j["pt_dist"])) * 1e3 if len(j["pt_dist"]) else float("inf")
                  for j in full),
        # frames fed before a whole pass's first tracked frame, worst pass
        init_frames=max(p.get("init", 0) for _, p in whole),
        # the alignment's scale (1 when rigid): the worst pass's by ATE, and
        # the median over whole passes
        worst_pass_scale=full[int(np.argmax(pass_ate))]["scale"],
        scale=float(np.median([j["scale"] for j in full])),
        calls_checked=len(calls),
        calls_by_kernel={k: sum(c["name"] == k for c in calls) for k in ("window_match",
                                                                         "hamming_best2")},
    )
    # a matcher whose calls the recorder never saw is not checked: not correct
    readings["wrong_rows"] = (sum(reference.wrong_rows(c) for c in calls)
                              if all(readings["calls_by_kernel"].values()) else float("inf"))
    path = CHECKS_DIR / f"{workload}.json"
    limits = json.loads(path.read_text()) if path.exists() else {}
    checks = {k: dict(value=readings[k], limit=v) for k, v in limits.items()}
    correct = bool(limits) and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    return dict(correct=correct, ate_mm=readings["ate_mm"], checks=checks,
                readings=readings)
