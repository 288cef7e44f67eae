"""The judge by sensor: a monocular pass is aligned by a similarity, so a
pass moved by any similarity reads as the unmoved one; RGB-D and stereo
keep the rigid alignment, and on recorded passes read exactly what the
judge read before the similarity path was added
(``data/passes/parent_verdicts.json``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from slambench import control, harness, reference, registry
from slambench.tests.test_slambench_window import _orbit
from slambench.world import load_scene, load_trajectory

PASSES = Path(__file__).resolve().parent / "data" / "passes"
COMPARED = ("ate_mm", "worst_pass_ate_mm", "rpe_mm", "kf_mm", "pt_mm")


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _moved(run: dict, a: float, Q: np.ndarray, b: np.ndarray) -> dict:
    """``run`` in a map whose points are X' = a Q X + b."""
    def poses(T):
        T = np.array(T, np.float64)
        R = T[:, :3, :3] @ Q.T
        T[:, :3, 3] = a * T[:, :3, 3] - R @ b
        T[:, :3, :3] = R
        return T
    return dict(run, Tcw=poses(run["Tcw"]), kf_Tcw=poses(run["kf_Tcw"]),
                points=a * np.asarray(run["points"], np.float64) @ Q.T + b)


def _noisy_pass(seed: int):
    """A whole pass whose poses, keyframes and points err by millimetres."""
    rng = np.random.default_rng(seed)
    gt, stamps = _orbit(60), np.arange(60) / 30.0
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.002, (60, 3))
    s = load_scene("room").surfaces[0]
    pts = (s.p0 + np.outer(rng.random(200), s.eu) + np.outer(rng.random(200), s.ev)
           + rng.normal(0, 0.003, (200, 3)))
    run = dict(ts=stamps, Tcw=est, kf_frame=np.array([0, 20, 40]), kf_Tcw=est[[0, 20, 40]],
               points=pts, complete=True, fed=60, init=0, logged=60, lost=0)
    return run, dict(Tcw=gt, stamps=stamps, surfaces=[s])


def _right_calls(rng) -> list:
    """One call of each matcher with the plain best-2's answer."""
    a, b = (rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32) for n in (6, 9))
    mask = rng.random((6, 9)) < 0.5
    rows, cols = np.nonzero(mask)
    masked = dict(name="hamming_best2", band=None, args=[a, b, mask],
                  out=list(reference.best2(a, b, rows, cols, 6)))
    args = [a, b, rng.random((6, 2)).astype(np.float32) * 10,
            rng.random((9, 2)).astype(np.float32) * 10, np.full(6, 5.0, np.float32),
            np.zeros(6, np.int32), np.zeros(9, np.int32), np.ones(6, bool), np.ones(9, bool)]
    rows, cols = reference.window_candidates(*args[2:], (-1, 0))
    window = dict(name="window_match", band=(-1, 0), args=args,
                  out=list(reference.best2(a, b, rows, cols, 6)))
    return [masked, window]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_similarity_moved_monocular_pass_reads_as_unmoved(seed):
    run, inputs = _noisy_pass(seed)
    rng = np.random.default_rng(100 + seed)
    a = float(10.0 ** rng.uniform(-1, 1))
    moved = _moved(run, a, _rotation(rng), rng.normal(0, 3, 3))
    base = harness.judge([run], inputs, [], "x", "monocular")["readings"]
    got = harness.judge([moved], inputs, [], "x", "monocular")["readings"]
    assert base["worst_pass_ate_mm"] > 1.0 and base["pt_mm"] > 1.0
    for key in COMPARED:
        assert np.isclose(got[key], base[key], rtol=1e-9, atol=0), (key, got[key], base[key])
    assert np.isclose(got["scale"] * a, base["scale"], rtol=1e-9)


def test_the_scaled_pass_fails_rigidly(monkeypatch):
    from slambench.tests.tiny import CHECKS

    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    run, inputs = _noisy_pass(4)
    rng = np.random.default_rng(7)
    moved = _moved(run, 0.37, _rotation(rng), rng.normal(0, 3, 3))
    calls = _right_calls(rng)
    mono = harness.judge([moved], inputs, calls, "tum_rgbd.desk_orbit", "monocular")
    rgbd = harness.judge([moved], inputs, calls, "tum_rgbd.desk_orbit", "rgbd")
    assert mono["correct"], mono["checks"]
    assert not rgbd["correct"]
    assert rgbd["checks"]["worst_pass_ate_mm"]["value"] > 10 * mono["readings"]["worst_pass_ate_mm"]
    assert rgbd["readings"]["scale"] == 1.0


def _recorded(name: str):
    z = np.load(PASSES / f"{name}.npz")
    run = {k: (z[k].item() if z[k].ndim == 0 else z[k]) for k in z.files}
    return run


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_rigid_sensors_read_what_they_read_before(sensor):
    """A tiny CPU run's whole pass of each cell's sensor, judged as the
    judge before the similarity path judged it, key for key."""
    before = json.loads((PASSES / "parent_verdicts.json").read_text())[sensor]
    spec = registry.cell(registry.load_benchmark(), before["workload"])
    traffic, fps = spec["traffic"], spec["config"]["system"]["camera"]["fps"]
    run = _recorded(sensor)
    inputs = dict(Tcw=load_trajectory(traffic["trajectory"])[:run["fed"]],
                  stamps=np.arange(run["fed"]) / fps,
                  surfaces=load_scene(traffic["scene"]).surfaces)
    verdict = harness.judge([run], inputs, [], before["workload"], sensor)
    for key, value in before["readings"].items():
        assert verdict["readings"][key] == value, key
    assert verdict["checks"] == before["checks"]
    assert verdict["correct"] is before["correct"]
    assert verdict["readings"]["init_frames"] == 0 and verdict["readings"]["scale"] == 1.0


def test_a_monocular_pass_counts_lost_frames_from_its_first_tracked_one():
    """Frames before the first pose are ``init_frames``; a pass that lost
    its map and started again counts the frames in between as lost."""
    run, inputs = _noisy_pass(5)
    waited = dict(run, ts=run["ts"][7:], Tcw=run["Tcw"][7:], logged=53, init=7)
    v = harness.judge([waited], inputs, [], "x", "monocular")["readings"]
    assert (v["init_frames"], v["lost_frames"]) == (7, 0)
    assert harness.failed_frames([waited], "monocular") == 0
    rigid = harness.judge([waited], inputs, [], "x", "rgbd")["readings"]
    assert (rigid["init_frames"], rigid["lost_frames"]) == (7, 7)
    assert harness.failed_frames([waited], "rgbd") == 7
    # reset after a loss at frame 30: the trajectory holds frames 40-59 only
    again = dict(run, ts=run["ts"][40:], Tcw=run["Tcw"][40:], logged=20, init=7)
    v = harness.judge([again], inputs, [], "x", "monocular")["readings"]
    assert (v["init_frames"], v["lost_frames"]) == (7, 33)
    assert harness.failed_frames([again], "monocular") == 33


@pytest.mark.parametrize("seed", [11, 2**31 + 12345])
def test_the_monocular_control_reads_the_same_in_its_drawn_unit(seed):
    gt, stamps = _orbit(40), np.arange(40) / 30.0
    inputs = dict(Tcw=gt, stamps=stamps, surfaces=load_scene("room").surfaces)
    unit = control.map_unit(seed)
    assert unit != 1.0
    for bits in control.PRECISIONS.values():
        base = harness.judge([control.control_pass(inputs, bits, seed)], inputs, [], "x",
                             "monocular")["readings"]
        drawn = harness.judge([control.control_pass(inputs, bits, seed, unit)], inputs, [],
                              "x", "monocular")["readings"]
        for key in COMPARED:
            assert np.isclose(drawn[key], base[key], rtol=1e-9, atol=0), key
        assert np.isclose(drawn["scale"], base["scale"] * unit, rtol=1e-9)
