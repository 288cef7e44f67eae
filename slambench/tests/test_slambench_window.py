"""The window's arithmetic and the trajectory reference on known inputs."""

from __future__ import annotations

import numpy as np

from slambench import harness, reference
from slambench.world import _look_at


def test_rate_over_the_whole_window():
    times = [0.03] * 90 + [0.3] * 10               # 2.7 + 3.0 = 5.7 s for 100 frames
    m = harness.window_metrics(times)
    assert np.isclose(m["frames_per_s"], 100 / 5.7)


def test_percentiles_over_all_frames():
    times = np.linspace(0.010, 0.109, 100)
    m = harness.window_metrics(times)
    assert np.isclose(m["frame_p50_ms"], np.percentile(times, 50) * 1e3)
    assert np.isclose(m["frame_p95_ms"], np.percentile(times, 95) * 1e3)


def test_a_stall_moves_the_tail_and_not_the_median():
    steady = [0.033] * 200
    stalled = steady[:188] + [0.5] * 12             # 6% of frames carry a mapping step
    a, b = harness.window_metrics(steady), harness.window_metrics(stalled)
    assert np.isclose(a["frame_p50_ms"], b["frame_p50_ms"])
    assert b["frame_p95_ms"] > 10 * a["frame_p95_ms"]
    assert b["frames_per_s"] < a["frames_per_s"]


def _orbit(n):
    ang = np.linspace(0, 1.5, n)
    return np.stack([_look_at([2 * np.cos(a), 2 * np.sin(a), 1.2], [0, 0, 0.5], [0, 0, 1])
                     for a in ang])


def _rigid(rot_z, shift):
    c, s = np.cos(rot_z), np.sin(rot_z)
    S = np.eye(4)
    S[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    S[:3, 3] = shift
    return S


def test_ate_zero_under_a_rigid_transform():
    gt = _orbit(50)
    S = _rigid(0.7, [0.3, -1.0, 2.0])               # the map's frame against the world's
    est = gt @ S                                    # Tcw' = Tcw S
    run = dict(ts=np.arange(50) / 30.0, Tcw=est, kf_frame=np.array([0, 20]),
               kf_Tcw=est[[0, 20]], points=np.zeros((0, 3)))
    j = reference.judge_pass(run, gt, np.arange(50) / 30.0, [])
    assert j["n_tracked"] == 50
    assert np.sqrt(j["sq_err"].mean()) < 1e-9
    assert j["rpe"].max() < 1e-9 and j["kf_err"].max() < 1e-9


def test_ate_reads_a_known_offset():
    """Every other centre pushed 2 mm along the world's z: after the best
    rigid fit the RMS error is 1 mm."""
    gt = _orbit(60)
    est = gt.copy()
    for i in range(0, 60, 2):
        shift = np.eye(4)
        shift[:3, 3] = [0, 0, 0.002]
        est[i] = gt[i] @ np.linalg.inv(shift)       # centre moved by +2 mm in z
    run = dict(ts=np.arange(60) / 30.0, Tcw=est, kf_frame=np.zeros(0, int),
               kf_Tcw=np.zeros((0, 4, 4)), points=np.zeros((0, 3)))
    j = reference.judge_pass(run, gt, np.arange(60) / 30.0, [])
    assert np.isclose(np.sqrt(j["sq_err"].mean()), 0.001, rtol=1e-3)


def test_points_on_the_scene_read_zero():
    from slambench.world import load_scene

    world = load_scene("room")
    s = world.surfaces[0]
    pts = s.p0 + np.outer([0.2, 0.5, 0.9], s.eu) + np.outer([0.3, 0.6, 0.1], s.ev)
    assert reference.surface_distance(pts, world.surfaces).max() < 1e-6
    off = pts + 0.01 * s.normal
    assert np.allclose(reference.surface_distance(off, world.surfaces), 0.01, atol=1e-6)


def test_best2_ties_and_empty_rows():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, (4, 8)).astype(np.int32)
    b = np.concatenate([a[[0, 0]], rng.integers(-2**31, 2**31, (3, 8)).astype(np.int32)])
    rows, cols = np.array([0, 0, 0, 1]), np.array([1, 0, 2, 3])
    d1, i1, d2 = reference.best2(a, b, rows, cols, 4)
    assert (d1[0], i1[0], d2[0]) == (0, 0, 0)      # two columns tie: lowest wins, d2 = d1
    assert d2[1] == reference.BIG                   # one candidate
    assert (d1[2], i1[2], d2[2]) == (reference.BIG, 0, reference.BIG)


def test_matchers_unchecked_or_wrong_are_not_correct(monkeypatch):
    """The verdict: a sound pass and a right answer of each matcher pass;
    a wrong row, or a matcher with no checked call, does not."""
    from slambench.tests.tiny import CHECKS
    from slambench.world import load_scene

    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    gt, stamps = _orbit(40), np.arange(40) / 30.0
    s = load_scene("room").surfaces[0]
    pts = s.p0 + np.outer([0.2, 0.5], s.eu) + np.outer([0.3, 0.6], s.ev)
    run = dict(ts=stamps, Tcw=gt, kf_frame=np.array([0, 20]), kf_Tcw=gt[[0, 20]],
               points=pts, complete=True, fed=40, logged=40, lost=0)
    inputs = dict(Tcw=gt, stamps=stamps, surfaces=[s])
    rng = np.random.default_rng(1)
    a, b = (rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32) for n in (6, 9))
    mask = rng.random((6, 9)) < 0.5
    rows, cols = np.nonzero(mask)
    masked = dict(name="hamming_best2", band=None, args=[a, b, mask],
                  out=list(reference.best2(a, b, rows, cols, 6)))
    uv = rng.random((6, 2)).astype(np.float32) * 10
    args = [a, b, uv, rng.random((9, 2)).astype(np.float32) * 10,
            np.full(6, 5.0, np.float32), np.zeros(6, np.int32), np.zeros(9, np.int32),
            np.ones(6, bool), np.ones(9, bool)]
    rows, cols = reference.window_candidates(*args[2:], (-1, 0))
    window = dict(name="window_match", band=(-1, 0), args=args,
                  out=list(reference.best2(a, b, rows, cols, 6)))
    assert harness.judge([run], inputs, [masked, window], "tum_rgbd.desk_orbit")["correct"]
    assert not harness.judge([run], inputs, [masked], "tum_rgbd.desk_orbit")["correct"]
    wrong = dict(window, out=[window["out"][0], window["out"][1] + 1, window["out"][2]])
    verdict = harness.judge([run], inputs, [masked, wrong], "tum_rgbd.desk_orbit")
    assert not verdict["correct"] and verdict["readings"]["wrong_rows"] == 6


def test_lost_frames_count_lost_and_unlogged_frames_of_a_whole_pass(monkeypatch):
    from slambench.tests.tiny import CHECKS

    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    gt, stamps = _orbit(40), np.arange(40) / 30.0
    kept = np.arange(0, 40, 2)                      # every second frame never logged
    run = dict(ts=stamps[kept], Tcw=gt[kept], kf_frame=np.zeros(0, int),
               kf_Tcw=np.zeros((0, 4, 4)), points=np.zeros((0, 3)), complete=True,
               fed=40, logged=20, lost=1)
    inputs = dict(Tcw=gt, stamps=stamps, surfaces=[])
    verdict = harness.judge([run], inputs, [], "tum_rgbd.desk_orbit")
    assert verdict["readings"]["lost_frames"] == 21
    assert verdict["readings"]["worst_pass_ate_mm"] < 1e-6
    assert not verdict["correct"] and verdict["checks"]["lost_frames"]["value"] == 21


def test_round_mantissa_is_bfloat16_and_tf32():
    import torch

    x = np.random.default_rng(2).normal(0, 300, 10000).astype(np.float32)
    bf16 = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(reference.round_mantissa(x, 7), bf16)
    tf32 = reference.round_mantissa(x, 10)
    assert np.all(np.abs(tf32 - x) <= np.abs(x) * 2.0 ** -11)
    assert np.array_equal(reference.round_mantissa(x, 23), x)


def test_the_lower_precision_control_is_not_correct(monkeypatch):
    """The reference in the program's place, in bfloat16: ground-truth poses
    err by millimetres, and the window test in bfloat16 moves candidates
    of a 752 x 480 image, which the exact best-2 check sees."""
    from slambench import control
    from slambench.tests.tiny import CHECKS
    from slambench.world import load_scene

    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    gt, stamps = _orbit(40), np.arange(40) / 30.0
    inputs = dict(Tcw=gt, stamps=stamps, surfaces=load_scene("room").surfaces)
    rng = np.random.default_rng(3)
    n1, n2 = 512, 400
    args = [rng.integers(-2**31, 2**31, (n1, 8)).astype(np.int32),
            rng.integers(-2**31, 2**31, (n2, 8)).astype(np.int32),
            (rng.random((n1, 2)) * [752, 480]).astype(np.float32),
            (rng.random((n2, 2)) * [752, 480]).astype(np.float32),
            (4 + 16 * rng.random(n1)).astype(np.float32),
            rng.integers(0, 8, n1).astype(np.int32), rng.integers(0, 8, n2).astype(np.int32),
            np.ones(n1, bool), np.ones(n2, bool)]
    mask = rng.random((n1, n2)) < 0.02
    calls = [dict(name="window_match", band=(-1, 0), args=args, out=None),
             dict(name="hamming_best2", band=None, args=args[:2] + [mask], out=None)]
    sound = control.control_calls(calls, 23)
    low = control.control_calls(calls, 7)
    exact = harness.judge([control.control_pass(inputs, 23, 0)], inputs, sound,
                          "tum_rgbd.desk_orbit")
    assert exact["correct"], exact["checks"]
    verdict = harness.judge([control.control_pass(inputs, 7, 0)], inputs, low,
                            "tum_rgbd.desk_orbit")
    assert not verdict["correct"]
    assert verdict["readings"]["wrong_rows"] > 0
    assert 1.0 < verdict["readings"]["worst_pass_ate_mm"] < 10.0
