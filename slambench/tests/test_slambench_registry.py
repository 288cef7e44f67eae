"""A configuration, a traffic mix and a per-layer metric added as new files
are found by their names, with no edit to a file that is there."""

from __future__ import annotations

import json

import numpy as np

from slambench import reference, registry


def test_new_cell_and_metric_found_by_name(tmp_path):
    bench = registry.load_benchmark()
    (tmp_path / "slambench" / "configs").mkdir(parents=True)
    (tmp_path / "slambench" / "traffic").mkdir()
    (tmp_path / "slambench" / "metrics").mkdir()
    config = json.loads((registry.ROOT / bench["configs"][0]["file"]).read_text())
    config["system"]["orb"]["n_features"] = 1500
    (tmp_path / "slambench" / "configs" / "tum_wide.json").write_text(json.dumps(config))
    (tmp_path / "slambench" / "traffic" / "desk_revisit.json").write_text(
        json.dumps({"scene": "room", "first": 120}))
    (tmp_path / "slambench" / "metrics" / "loop.close_s.py").write_text(
        "def read(r):\n    return r.get('close_s')\n")
    bench["configs"].append(dict(name="tum_wide", source="x", file="slambench/configs/tum_wide.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="tum_wide.desk_revisit", config="tum_wide",
                                   traffic="desk_revisit", chips=1, why="x"))
    bench["per_layer"].append(dict(name="loop.close_s", unit="s", better="lower",
                                   source="host_clock", layer="loop closing",
                                   moves="frames_per_s", workloads=["tum_wide.desk_revisit"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = registry.cell(registry.load_benchmark(tmp_path), "tum_wide.desk_revisit", tmp_path)
    assert spec["config"]["system"]["orb"]["n_features"] == 1500
    assert spec["traffic"] == {"scene": "room", "first": 120}
    assert [m["name"] for m in spec["per_layer"]] == ["loop.close_s"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"frames_per_s", "setup_s"}
    read = registry.metric_reader("loop.close_s", tmp_path / "slambench" / "metrics")
    assert read({"close_s": 2.5}) == 2.5 and read({}) is None


def test_every_cell_of_the_benchmark_resolves():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        spec = registry.cell(bench, w["name"])
        assert spec["traffic"]["first"] > spec["traffic"]["warmup_frames"]
        for m in spec["per_layer"]:
            assert callable(registry.metric_reader(m["name"]))


def test_new_scene_and_trajectory_found_by_name(tmp_path):
    from slambench import world

    (tmp_path / "corridor.json").write_text(json.dumps(dict(
        light=[0.0, 0.0, 1.0], ambient=0.5,
        boxes=[dict(center=[0, 0, 1.5], size=[20.0, 3.0, 3.0], seed=700, albedo=1.0)],
        rects=[dict(p0=[9.99, -1.0, 0.5], eu=[0, 2.0, 0], ev=[0, 0, 1.0], seed=750,
                    albedo=0.8)])))
    (tmp_path / "walk.csv").write_text(
        "eye_x,eye_y,eye_z,target_x,target_y,target_z,up_x,up_y,up_z\n"
        + "".join(f"{x},0,1.5,{x + 4},0,1.5,0,0,1\n" for x in (-5.0, -4.9, -4.8)))
    scene = world.load_scene("corridor", tmp_path)
    assert len(scene.surfaces) == 7 and scene.surfaces[-1].seed == 750
    poses = world.load_trajectory("walk", tmp_path)
    assert poses.shape == (3, 4, 4)
    assert np.allclose(reference.centres(poses)[:, 0], [-5.0, -4.9, -4.8])


def test_every_sensor_of_the_port_has_frames_and_an_entry():
    """A monocular configuration needs only files: its frames come from the
    same generator, one image each, and go to ``track_monocular_device``."""
    import torch

    from refactored_orb_slam2_tpu_torch.system import SlamSystem
    from slambench import harness
    from slambench.tests.tiny import tiny_spec

    spec = tiny_spec()
    spec["config"]["system"]["sensor"] = "monocular"
    cfg = harness.build_config(spec["config"])
    traffic = dict(spec["traffic"], first=2)
    got = harness.make_inputs(traffic, cfg, torch.device("cpu"))
    assert len(got["frames"]) == 2 and len(got["Tcw"]) == 2
    (img,) = got["frames"][0]
    assert img.dtype == torch.uint8 and img.shape == (cfg.camera.height, cfg.camera.width)
    for entry, _ in harness.SENSORS.values():
        assert callable(getattr(SlamSystem, entry))
