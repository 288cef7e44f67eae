"""The port's scale demo and its two benches on the CPU at a small size:

- ``scripts/run_scale_demo.py::run`` over 8 frames of the street circuit
  on a 64 x 8192 x 16 map: the JAX demo's JSON keys (and the port's
  timings), no frame lost, the pose-graph solver named by the rule
  ``K > pose_graph_dense_max``; ``--frames`` parses (default 700), and
  without CUDA and without ``--cpu`` the program exits non-zero;
- ``scripts/bench_dist_ba.py::make_problem`` equal to the JAX bench's
  problem, and one pass of the bench at 1, 2 and 4 shards;
- ``scripts/bench_pose_graph.py::circle_graph`` (the port's copy of
  ``tests/test_pose_graph.py``'s fixture) equal to the original within
  float32 rounding, and one pass of the bench at K = 32, dense and PCG.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.config import MapConfig
from refactored_orb_slam2_tpu_torch.scripts import bench_dist_ba, bench_pose_graph
from refactored_orb_slam2_tpu_torch.scripts import run_scale_demo as R
from test_pose_graph import circle_graph

torch.set_num_threads(1)

JAX_KEYS = {"frames", "lost", "keyframes", "points", "wall_s", "mapping_ms_per_kf",
            "loop_closed", "gba_runs", "pose_graph_solver", "capacity_warnings"}


def test_scale_demo_small_map_on_cpu():
    cfg = MapConfig(max_keyframes=64, max_points=8192, max_obs_per_point=16)
    out = R.run(8, "cpu", cfg)
    json.dumps(out)
    assert JAX_KEYS <= set(out)
    assert set(out["mapping_ms_per_kf"]) == {"first_third", "middle_third", "last_third"}
    assert out["frames"] == 8 and out["lost"] == 0
    assert 2 <= out["keyframes"] <= 8 and out["points"] > 500
    assert out["pose_graph_solver"] == ("pcg" if cfg.max_keyframes > cfg.pose_graph_dense_max
                                        else "dense") == "dense"
    assert out["capacity_warnings"] == [] and out["device"] == "cpu"
    assert out["frame_ms"]["median"] > 0 and not out["loop_closed"] and out["gba_ms"] == []
    # the default map is the KITTI-scale one, where the rule picks PCG
    big = R.scale_config().map
    assert (big.max_keyframes, big.max_points, big.max_obs_per_point) == (2048, 262144, 16)
    assert big.max_keyframes > big.pose_graph_dense_max


def test_scale_demo_arguments():
    assert R.parse_args([]).frames == 700 and not R.parse_args([]).cpu
    args = R.parse_args(["--frames", "180", "--cpu"])
    assert args.frames == 180 and args.cpu
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            R.main(["--frames", "1"])
        assert e.value.code not in (0, None)


def _jax_bench():
    path = Path(__file__).resolve().parents[1] / "scripts" / "bench_dist_ba.py"
    spec = importlib.util.spec_from_file_location("jax_bench_dist_ba", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_dist_ba_problem_and_one_pass():
    ref = _jax_bench().make_problem(8, 512, 6)
    got = bench_dist_ba.make_problem(8, 512, 6)
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-6, err_msg=f)
    rec = bench_dist_ba.main(["--cpu", "--kf", "6", "--pts", "256", "--obs", "4",
                              "--iters", "2", "--shards", "4", "--reps", "1"])
    assert set(rec["iters_per_s"]) == {"1", "2", "4"} and rec["shards"] == 4
    assert rec["distinct_devices"] == 1 and rec["value"] > 0


def test_bench_pose_graph_fixture_and_one_pass():
    for args in ((24, 0.02, 0.0, 0), (512, 0.015, 0.0, 5), (12, 0.02, 0.02, 1)):
        for r, g in zip(circle_graph(*args), bench_pose_graph.circle_graph(*args)):
            for a, b in zip(r, g):
                np.testing.assert_allclose(b, a, atol=1e-5)
    recs = bench_pose_graph.main(["--cpu", "--sizes", "32"])
    assert [r["solver"] for r in recs] == ["dense", "pcg"]
    assert all(r["converged"] and r["K"] == 32 for r in recs)
