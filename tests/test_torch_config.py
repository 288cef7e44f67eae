"""The port's own copies of the JAX package's JAX-free modules stay equal to
the originals: the config tree (classes, fields, defaults, the settings
loader), the per-dataset presets, the rBRIEF pattern table, the telemetry
counters and the dataset readers (``io/datasets.py``, code below the
module docstring).  Exact equality throughout: these are settings, data
and host code, not arithmetic.
"""

import dataclasses
import logging

import numpy as np
import pytest

from refactored_orb_slam2_tpu.ops import orb_pattern as j_pattern
from refactored_orb_slam2_tpu.utils import config as j_config
from refactored_orb_slam2_tpu.utils import presets as j_presets
from refactored_orb_slam2_tpu.utils import telemetry as j_telemetry
from refactored_orb_slam2_tpu_torch import config as t_config
from refactored_orb_slam2_tpu_torch.io.convert import config_from_reference
from refactored_orb_slam2_tpu_torch.ops import orb_pattern as t_pattern
from refactored_orb_slam2_tpu_torch.utils import presets as t_presets
from refactored_orb_slam2_tpu_torch.utils import telemetry as t_telemetry

CLASSES = ("CameraConfig", "ORBConfig", "MatcherConfig", "TrackingConfig",
           "MapConfig", "LoopConfig", "SystemConfig")

SETTINGS = (
    "%YAML:1.0\n\n"
    "Camera.fx: 517.3\nCamera.fy: 516.5\nCamera.cx: 318.6\nCamera.cy: 255.3\n"
    "Camera.k1: 0.26\nCamera.k2: -0.95\nCamera.p1: -0.005\nCamera.p2: 0.002\n"
    "Camera.k3: 1.16\nCamera.fps: 25.0\nCamera.RGB: 0\nCamera.bf: 40.0\n"
    "Camera.width: 752\nCamera.height: 480\n"
    "ORBextractor.nFeatures: 1200\nORBextractor.scaleFactor: 1.25\n"
    "ORBextractor.nLevels: 6\nORBextractor.iniThFAST: 18\n"
    "ORBextractor.minThFAST: 5\nThDepth: 40.0\nDepthMapFactor: 5000.0\n"
    "LEFT.K: !!opencv-matrix\n   rows: 3\n   cols: 3\n   dt: d\n"
    "   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]\n"
)


def _reference_config():
    """A JAX-package config with a non-default value in every part."""
    J = j_config
    return J.SystemConfig(
        sensor="rgbd", vocab_path="v.npz", allow_vocab_fallback=True,
        camera=J.CameraConfig(fx=400.0, bf=200.0, width=320, height=240, rgb=False),
        orb=J.ORBConfig(n_features=500, n_levels=4, max_keypoints=768),
        matcher=J.MatcherConfig(th_low=40, nn_ratio_ref_kf=0.8),
        tracking=J.TrackingConfig(th_depth=20.0, seed_pose_opt_from_prediction=True),
        map=J.MapConfig(max_keyframes=24, max_points=4096, pose_graph_solver="pcg"),
        loop=J.LoopConfig(kf_gap=2),
    )


@pytest.mark.parametrize("name", CLASSES)
def test_config_class_has_the_reference_fields_and_defaults(name):
    jc, tc = getattr(j_config, name), getattr(t_config, name)
    assert tc.__module__ == "refactored_orb_slam2_tpu_torch.config"
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
    assert tc.__dataclass_params__.frozen and jc.__dataclass_params__.frozen


def test_padded_keypoints_and_replace_agree():
    for kw in (dict(n_features=1000), dict(n_features=500), dict(n_features=1025),
               dict(n_features=300, max_keypoints=384)):
        assert (t_config.ORBConfig(**kw).padded_keypoints
                == j_config.ORBConfig(**kw).padded_keypoints)
    t, j = t_config.SystemConfig(), j_config.SystemConfig()
    assert (dataclasses.asdict(t.replace(sensor="stereo"))
            == dataclasses.asdict(j.replace(sensor="stereo")))


@pytest.mark.parametrize("sensor", ["monocular", "rgbd"])
def test_load_settings_gives_equal_trees(tmp_path, sensor):
    path = tmp_path / "settings.yaml"
    path.write_text(SETTINGS)
    j = j_config.load_settings(str(path), sensor=sensor)
    t = t_config.load_settings(str(path), sensor=sensor)
    assert isinstance(t, t_config.SystemConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.camera.width == 752 and t.orb.n_features == 1200 and not t.camera.rgb
    assert t.tracking.max_frames_between_kf == 25


def test_load_settings_defaults_on_an_empty_file(tmp_path):
    path = tmp_path / "empty.yaml"
    path.write_text("%YAML:1.0\n")
    assert (dataclasses.asdict(t_config.load_settings(str(path)))
            == dataclasses.asdict(j_config.load_settings(str(path))))


def test_config_from_reference_round_trips():
    ref = _reference_config()
    got = config_from_reference(ref)
    assert isinstance(got, t_config.SystemConfig)
    for part in ("camera", "orb", "matcher", "tracking", "map", "loop"):
        assert type(getattr(got, part)) is getattr(t_config, type(getattr(ref, part)).__name__)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    # back into the JAX package's classes through the same field names
    back = j_config.SystemConfig(**{
        f.name: (type(getattr(ref, f.name))(**dataclasses.asdict(getattr(got, f.name)))
                 if dataclasses.is_dataclass(getattr(got, f.name)) else getattr(got, f.name))
        for f in dataclasses.fields(got)})
    assert back == ref
    # the port's own tree passes through unchanged
    assert config_from_reference(got) == got


def test_config_from_reference_takes_a_part_and_refuses_strangers():
    orb = config_from_reference(j_config.ORBConfig(n_features=500, n_levels=4))
    assert orb == t_config.ORBConfig(n_features=500, n_levels=4)

    @dataclasses.dataclass
    class ORBConfig:                     # a field the port does not have
        n_features: int = 5
        n_octaves: int = 3

    with pytest.raises(TypeError):
        config_from_reference(ORBConfig())

    @dataclasses.dataclass
    class Unknown:
        x: int = 0

    with pytest.raises(AttributeError):
        config_from_reference(Unknown())


@pytest.mark.parametrize("name", j_presets.preset_names())
def test_preset_equals_the_reference(name):
    j, t = j_presets.get_preset(name), t_presets.get_preset(name)
    assert isinstance(t, t_config.SystemConfig)
    assert type(t.camera) is t_config.CameraConfig
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert config_from_reference(j) == t
    assert t.sensor == {"mono": "monocular", "stereo": "stereo", "rgbd": "rgbd"}[
        name.split("_")[0]]


def test_presets_module_agrees_beyond_the_named_presets():
    assert t_presets.preset_names() == j_presets.preset_names()
    assert len(t_presets.preset_names()) == 14
    over = dict(sensor="stereo", vocab_path="v.npz")
    assert (dataclasses.asdict(t_presets.get_preset("stereo_euroc", **over))
            == dataclasses.asdict(j_presets.get_preset("stereo_euroc", **over)))
    with pytest.raises(KeyError, match="unknown preset"):
        t_presets.get_preset("stereo_mars")
    for seq in (0, 2, 3, 4, 10):
        for sensor in ("stereo", "monocular"):
            assert (dataclasses.asdict(t_presets.kitti_preset_for_sequence(seq, sensor))
                    == dataclasses.asdict(j_presets.kitti_preset_for_sequence(seq, sensor)))
    assert t_presets.EUROC_RECTIFICATION.keys() == j_presets.EUROC_RECTIFICATION.keys()
    for key, val in j_presets.EUROC_RECTIFICATION.items():
        np.testing.assert_array_equal(t_presets.EUROC_RECTIFICATION[key], val)


def test_brief_pattern_tables_are_equal():
    assert t_pattern.BRIEF_PATTERN is not j_pattern.BRIEF_PATTERN
    assert t_pattern.BRIEF_PATTERN.dtype == j_pattern.BRIEF_PATTERN.dtype == np.int8
    assert t_pattern.BRIEF_PATTERN.shape == (256, 4)
    np.testing.assert_array_equal(t_pattern.BRIEF_PATTERN, j_pattern.BRIEF_PATTERN)


def test_telemetry_copy_counts_and_warns_like_the_reference(caplog):
    assert t_telemetry is not j_telemetry
    assert t_telemetry.WARN_EVERY == j_telemetry.WARN_EVERY
    for tel in (t_telemetry, j_telemetry):
        tel.reset()
    with caplog.at_level(logging.WARNING):
        for tel in (t_telemetry, j_telemetry):
            tel.inc("frames", 3)
            for _ in range(tel.WARN_EVERY + 1):
                tel.warn("cap", "map is full")
            with tel.timer("stage"):
                pass
    t, j = t_telemetry.snapshot(), j_telemetry.snapshot()
    assert t["counters"] == j["counters"] == {"frames": 3, "warn.cap": 101}
    assert t["timers"]["stage"]["count"] == j["timers"]["stage"]["count"] == 1
    assert t_telemetry.warned_keys() == j_telemetry.warned_keys() == ["cap"]
    by_logger = {name: [r.getMessage() for r in caplog.records if r.name == name]
                 for name in ("refactored_orb_slam2_tpu_torch", "refactored_orb_slam2_tpu")}
    assert (by_logger["refactored_orb_slam2_tpu_torch"]
            == by_logger["refactored_orb_slam2_tpu"]
            == ["map is full", "map is full (x101)"])
    for tel in (t_telemetry, j_telemetry):
        tel.reset()
    assert t_telemetry.get("frames") == 0


def test_vocabulary_asset_copy_equal():
    """The port loads its own copy of the packaged vocabulary: the same
    4096 words (uint32 in the file, int32 words once loaded) and idf."""
    import os

    import refactored_orb_slam2_tpu
    from refactored_orb_slam2_tpu_torch.place.vocab import load_vocabulary
    from refactored_orb_slam2_tpu_torch.system import VOCAB_ASSET

    original = os.path.join(os.path.dirname(refactored_orb_slam2_tpu.__file__),
                            "assets", "vocab.npz")
    assert os.path.abspath(VOCAB_ASSET) != os.path.abspath(original)
    j, t = np.load(original), np.load(VOCAB_ASSET)
    assert sorted(t.files) == sorted(j.files) == ["idf", "words"]
    for key in ("words", "idf"):
        assert t[key].dtype == j[key].dtype and t[key].shape == j[key].shape
        np.testing.assert_array_equal(t[key], j[key])
    assert j["words"].shape == (4096, 8) and j["words"].dtype == np.uint32
    vocab = load_vocabulary(VOCAB_ASSET)
    np.testing.assert_array_equal(vocab.words.numpy().view(np.uint32), j["words"])
    np.testing.assert_array_equal(vocab.idf.numpy(), j["idf"])


def test_dataset_readers_copy_equal():
    """``io/datasets.py`` is the original's code word for word: the module
    without its docstring parses to the same tree."""
    import ast
    import inspect

    from refactored_orb_slam2_tpu.io import datasets as j_datasets
    from refactored_orb_slam2_tpu_torch.io import datasets as t_datasets

    def body(module):
        tree = ast.parse(inspect.getsource(module))
        assert isinstance(tree.body[0].value, ast.Constant)       # the docstring
        tree.body = tree.body[1:]
        return ast.dump(tree)

    assert t_datasets is not j_datasets
    assert body(t_datasets) == body(j_datasets)
    assert [n for n in dir(t_datasets) if not n.startswith("__")] == \
        [n for n in dir(j_datasets) if not n.startswith("__")]
