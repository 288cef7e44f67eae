"""The port's spans and its ``host_reads`` counter (``utils/telemetry.py``).

- Spans nest per thread, carry their parent, key and thread, and leave no
  record while tracing is off, where the aggregate stays one entry a name.
- Span records share ``torch.profiler``'s host clock.
- On the tiny RGB-D system of ``test_torch_slice.py`` (320x240, 500
  features, a 24 x 4096 x 8 map), in cooperative mode both synchronous and
  pipelined at depth 1 (the benchmark's mode): a steady fused frame's span
  holds the dispatch with the fused step's seven stages in order and the
  commit with its read; a keyframe's mapping spans come in
  ``_mapping_steps``' order under the keyframe's key; a steady frame makes
  the host reads its docstrings state.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch import config as C
from refactored_orb_slam2_tpu_torch.system import SlamSystem
from refactored_orb_slam2_tpu_torch.utils import telemetry
from refactored_orb_slam2_tpu_torch.utils import world3d as W

torch.set_num_threads(1)

CFG = C.SystemConfig(
    sensor="rgbd",
    camera=C.CameraConfig(fx=258.65, fy=258.25, cx=159.3, cy=127.65, bf=20.0,
                          width=320, height=240),
    orb=C.ORBConfig(n_features=500, n_levels=4),
    map=C.MapConfig(max_keyframes=24, max_points=4096, max_obs_per_point=8),
)
STAGES = ["track.build", "track.motion", "track.pose1", "track.local_select",
          "track.local_match", "track.pose2", "track.counts"]
#: ``_mapping_steps``' spans in order (LM chunks collapsed), then loop
#: detection, which cooperative mode runs last
MAPPING = ["mapping.work_sets", "mapping.triangulate", "mapping.fuse", "mapping.cull_points",
           "mapping.reconcile", "mapping.ba_gather", "mapping.ba_chunk",
           "mapping.ba_classify", "mapping.ba_chunk", "mapping.ba_scatter",
           "mapping.kf_redundancy", "mapping.kf_cull", "loop.detect"]
N_STEADY, N_FORCED = 6, 6


@pytest.fixture
def tracing():
    telemetry.reset()
    telemetry.tracing(True)
    yield
    telemetry.tracing(False)
    telemetry.reset()


def test_spans_nest_with_parent_key_and_thread(tracing):
    with telemetry.timer("outer", key=7):
        with telemetry.timer("inner"):
            telemetry.inc("host_reads")
        telemetry.inc("host_reads", 2)
        with telemetry.timer("other", key=8):
            pass

    def worker():
        with telemetry.timer("on_worker"):
            pass

    t = threading.Thread(target=worker, name="mapper-test")
    t.start()
    t.join()
    recs = {r["name"]: r for r in telemetry.spans()}
    assert set(recs) == {"outer", "inner", "other", "on_worker"}
    outer, inner, other = recs["outer"], recs["inner"], recs["other"]
    assert outer["parent"] is None and inner["parent"] == other["parent"] == outer["id"]
    assert (outer["key"], inner["key"], other["key"]) == (7, 7, 8)
    assert outer["counts"] == {"host_reads": 2} and inner["counts"] == {"host_reads": 1}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert outer["thread"] == threading.current_thread().name
    assert recs["on_worker"]["thread"] == "mapper-test"
    assert recs["on_worker"]["parent"] is None
    assert telemetry.spans() == []          # taken once
    assert telemetry.get("host_reads") == 3


def test_tracing_off_keeps_no_record_and_a_bounded_aggregate():
    telemetry.reset()
    with telemetry.timer("stage"):
        pass
    entry = telemetry._timers["stage"]
    size = (len(telemetry._timers), sys.getsizeof(entry), len(entry))
    for _ in range(10_000):
        with telemetry.timer("stage"):
            telemetry.inc("host_reads")
    assert (len(telemetry._timers), sys.getsizeof(entry), len(entry)) == size
    assert telemetry._timers["stage"] is entry
    assert telemetry.spans() == []
    snap = telemetry.snapshot()["timers"]["stage"]
    assert snap["count"] == 10_001
    assert snap["max_s"] >= snap["mean_s"] > 0
    assert snap["total_s"] == pytest.approx(snap["mean_s"] * 10_001)
    telemetry.reset()


def test_spans_share_the_profiler_clock(tracing):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with record_function("probe"):
            with telemetry.timer("probe"):
                pass
    (span,) = [r for r in telemetry.spans() if r["name"] == "probe"]
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert abs(span["start_ns"] - event.start_ns()) < 1_000_000


@pytest.fixture(scope="module", params=["fused", "pipelined"])
def traced_run(request):
    """Frames tracked with tracing on: ``N_STEADY`` as the system decides,
    then ``N_FORCED`` that each insert a keyframe, then mapping drained."""
    pipelined = request.param == "pipelined"
    slam = SlamSystem(CFG, device="cpu", cooperative_mapping=True, pipelined=pipelined,
                      pipeline_depth=1)
    world = W.scene_room(seed=11)
    poses = W.traj_room_orbit(160, seed=5, span=0.45 * np.pi)[:N_STEADY + N_FORCED]
    rng = np.random.default_rng(0)
    frames = [world.render(T, slam.cam, want_depth=True, noise=2.0, rng=rng) for T in poses]
    telemetry.reset()
    telemetry.tracing(True)
    try:
        for i, (img, depth) in enumerate(frames):
            if i == N_STEADY:
                slam._need_new_keyframe = lambda *a, **kw: True
            slam.track_rgbd(img, depth, i / 30.0)
        slam.flush_pipeline()
        slam.wait_mapping_idle()
        spans = telemetry.spans()
    finally:
        telemetry.tracing(False)
        telemetry.reset()
    return dict(mode=request.param, spans=spans, n_kf=slam.n_kf)


def _children(spans, parent):
    return sorted((r for r in spans if r["parent"] == parent["id"]),
                  key=lambda r: r["start_ns"])


def _steady_frames(spans):
    """Frame spans of the fused path with no keyframe, fallback or mapping
    step inside."""
    out = []
    for f in (r for r in spans if r["name"] == "frame"):
        names = [c["name"] for c in _children(spans, f)]
        inner = [g["name"] for c in _children(spans, f) for g in _children(spans, c)]
        if (sorted(names) == ["track.commit", "track.dispatch"]
                and "track.keyframe" not in inner and "track.fallback" not in inner):
            out.append(f)
    return out


def test_steady_frame_holds_dispatch_stages_and_commit(traced_run):
    spans = traced_run["spans"]
    steady = _steady_frames(spans)
    assert len(steady) >= 3
    for f in steady:
        kids = _children(spans, f)
        by_name = {k["name"]: k for k in kids}
        order = ["track.commit", "track.dispatch"] if traced_run["mode"] == "pipelined" \
            else ["track.dispatch", "track.commit"]
        assert [k["name"] for k in kids] == order
        dispatch, commit = by_name["track.dispatch"], by_name["track.commit"]
        assert [s["name"] for s in _children(spans, dispatch)] == STAGES
        assert all(s["key"] == f["key"] for s in _children(spans, dispatch))
        assert [s["name"] for s in _children(spans, commit)] == ["track.read"]
        # the pipelined commit is the previous frame's
        committed = f["key"] - (traced_run["mode"] == "pipelined")
        assert dispatch["key"] == f["key"] and commit["key"] == committed


def test_keyframe_mapping_spans_in_step_order_under_one_key(traced_run):
    spans = traced_run["spans"]
    assert traced_run["n_kf"] >= 6
    by_key: dict = {}
    for r in sorted(spans, key=lambda r: r["start_ns"]):
        if r["name"].startswith(("mapping.", "loop.")):
            by_key.setdefault(r["key"], []).append(r["name"])
    assert None not in by_key
    frames = {r["key"] for r in spans if r["name"] == "frame"}
    assert set(by_key) <= frames          # keyed by the frame that made it
    collapsed = {k: [n for i, n in enumerate(v) if i == 0 or n != v[i - 1]]
                 for k, v in by_key.items()}
    whole = [k for k, v in collapsed.items() if v == MAPPING]
    assert whole, collapsed
    # every keyframe's spans follow that order, cut where its map was smaller
    for names in collapsed.values():
        it = iter(MAPPING)
        assert all(n in it for n in names), names


def test_steady_frame_host_reads_are_as_documented(traced_run):
    spans = traced_run["spans"]

    def reads(r):
        return r["counts"].get("host_reads", 0) + sum(reads(c) for c in _children(spans, r))

    steady = _steady_frames(spans)
    assert steady and all(reads(f) == 2 for f in steady)
