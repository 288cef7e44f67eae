"""Map checkpoints: the port's ``io/checkpoint.py`` against the JAX package's.

- Round trip on a hand-filled tiny map (``tests/test_map.py:317-357``, with
  descriptor words that use the sign bit, a culled chain, a vocabulary and
  a KeyFrameDB): every bank, counter and vocabulary tensor bit-equal after
  the load, the descriptor words uint32 on disk.
- A capacity mismatch raises ``ValueError`` naming the field.
- Across packages, on a map the JAX ``SlamSystem`` built over the 12 frames
  of the ``tests/test_torch_reloc.py`` scenario (320x240, 500 features, 4
  levels, map 32 x 8192 x 8): the JAX file loads into the port, every field
  equal to ``io/convert.py::map_state_from_numpy`` of the JAX map; the port
  saves it again and JAX's ``load_map`` restores every field, the two files
  with equal keys, shapes and dtypes.
- A fresh system after a load is in ``NOT_INITIALIZED`` in both packages
  (ROADMAP.md, "Faults in the reference itself": the JAX loader never sets
  the tracking state, so the next frame would start a second map).  So the
  tests set ``state = LOST`` after each cross-load and hold what the JAX
  docstring promises: both packages relocalize the revisited view of frame
  6 on the loaded map, and with the JAX EPnP sets injected
  (``test_torch_epnp.jax_sets_injected``) the returned poses agree within
  ``tests/test_torch_reloc.py``'s POSE_TOL (1e-4).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu.io import checkpoint as JC
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam, TrackState as JState
from refactored_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from refactored_orb_slam2_tpu_torch.config import (
    CameraConfig, MapConfig, ORBConfig, SystemConfig,
)
from refactored_orb_slam2_tpu_torch.io import checkpoint as TC
from refactored_orb_slam2_tpu_torch.io.convert import map_state_from_numpy
from refactored_orb_slam2_tpu_torch.models.map_state import MapState
from refactored_orb_slam2_tpu_torch.place.keyframe_db import KeyFrameDB
from refactored_orb_slam2_tpu_torch.place.vocab import make_vocabulary
from refactored_orb_slam2_tpu_torch.system import SlamSystem as TSlam, TrackState
from test_torch_epnp import jax_sets_injected
from test_torch_reloc import CFG, N_TRACK, POSE_TOL, REVISIT, TCFG, WORLD, lateral

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(MapState)]
WORD_FIELDS = ("map_kf_desc", "map_pt_desc", "vocab_words")


def tiny_cfg(max_points=256):
    return SystemConfig(
        sensor="rgbd",
        camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=80.0,
                            width=320, height=240),
        orb=ORBConfig(n_features=200, n_levels=2),
        map=MapConfig(max_keyframes=8, max_points=max_points, max_obs_per_point=4),
    )


def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32))


def _hand_filled():
    """A port system with a tiny hand-filled map, vocabulary and database."""
    rng = np.random.default_rng(0)
    s = TSlam(tiny_cfg(), device="cpu")
    m = s.map
    K, N, P, O = m.capacity
    m.kf_valid[:2] = True
    m.kf_pose[1, :3, 3] = torch.tensor([0.1, -0.2, 0.3])
    m.kf_frame_id[:2] = torch.tensor([0, 7], dtype=torch.int32)
    m.kf_desc[:2] = _words(rng, (2, N, 8))
    m.kf_feat_valid[:2, :50] = True
    m.kf_xy[:2] = torch.from_numpy(rng.uniform(0, 320, (2, N, 2)).astype(np.float32))
    m.kf_parent[1] = 0
    m.pt_valid[:5] = True
    m.pt_pos[:5] = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    m.pt_desc[:5] = _words(rng, (5, 8))
    m.pt_obs_kf[:5, :2] = torch.tensor([0, 1], dtype=torch.int32)
    m.pt_obs_feat[:5, :2] = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    s.n_kf, s.n_pt, s.ref_kf = 2, 5, 1
    s.culled_chain = {3: (np.eye(4, dtype=np.float32) * 2, 1)}
    s.vocab = make_vocabulary(_words(rng, (16, 8)),
                              torch.from_numpy(rng.uniform(0, 3, 16).astype(np.float32)))
    s.db = KeyFrameDB(s.vocab, K)
    s.db.add(0, m.kf_desc[0], m.kf_feat_valid[0])
    s.db.add(1, m.kf_desc[1], m.kf_feat_valid[1])
    return s


def assert_same_state(a, b):
    """Every bank, counter, vocabulary tensor and database bank equal."""
    for name in FIELDS:
        x, y = getattr(a.map, name), getattr(b.map, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (a.n_kf, a.n_pt, a.ref_kf) == (b.n_kf, b.n_pt, b.ref_kf)
    assert a.culled_chain.keys() == b.culled_chain.keys()
    for k, (T, parent) in a.culled_chain.items():
        np.testing.assert_array_equal(b.culled_chain[k][0], T)
        assert b.culled_chain[k][1] == parent
    for name in ("words", "words_pm1", "idf"):
        assert torch.equal(getattr(a.vocab, name), getattr(b.vocab, name)), name
    assert torch.equal(a.db.bow, b.db.bow) and torch.equal(a.db.valid, b.db.valid)


def test_round_trip_is_bit_exact(tmp_path):
    s = _hand_filled()
    path = str(tmp_path / "map.npz")
    TC.save_map(path, s)
    s2 = TSlam(tiny_cfg(), device="cpu")
    TC.load_map(path, s2)
    assert_same_state(s, s2)
    assert s2.state == TrackState.NOT_INITIALIZED        # as the JAX loader leaves it
    assert s2.db.vocab is s2.vocab and s2.db.bow.shape == (8, 16)
    with np.load(path, allow_pickle=False) as z:
        for key in WORD_FIELDS:
            assert z[key].dtype == np.uint32, key
        assert (z["map_kf_desc"] >= 2**31).any()         # the sign bit crossed
        meta = json.loads(str(z["meta"]))
    assert meta == {"n_kf": 2, "n_pt": 5, "ref_kf": 1, "sensor": "rgbd",
                    "culled_chain": {"3": [(np.eye(4) * 2).tolist(), 1]}}


def test_map_without_vocabulary_round_trips(tmp_path):
    s = TSlam(tiny_cfg(), device="cpu")
    s.map.pt_valid[:3] = True
    s.n_pt = 3
    path = str(tmp_path / "map.npz")
    TC.save_map(path, s)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(["meta"] + [f"map_{k}" for k in FIELDS])
    s2 = TSlam(tiny_cfg(), device="cpu")
    TC.load_map(path, s2)
    assert s2.vocab is None and s2.db is None and s2.n_pt == 3
    for name in FIELDS:
        assert torch.equal(getattr(s.map, name), getattr(s2.map, name)), name


def test_capacity_mismatch_raises(tmp_path):
    path = str(tmp_path / "map.npz")
    TC.save_map(path, TSlam(tiny_cfg(256), device="cpu"))
    s2 = TSlam(tiny_cfg(512), device="cpu")
    with pytest.raises(ValueError, match="capacity mismatch for pt_pos"):
        TC.load_map(path, s2)


# ------------------------------------------------------- across the packages
def _revisit_state():
    """The JAX system that built the map over the 12 tracked frames, the
    revisited view (rendered after them) and its pose."""
    world = SyntheticWorld.create(**WORLD)
    slam = JSlam(CFG)
    slam.loop_closing_enabled = False
    rng = np.random.default_rng(9)
    traj = lateral(N_TRACK)
    for i, T in enumerate(traj):
        img, depth = world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam)
        assert slam.track_rgbd(img, depth, i * 0.1) is not None
    assert slam.n_kf > 5 and slam.vocab is not None
    T = traj[REVISIT]
    revisit = (world.render(T, slam.cam, noise=2.0, rng=rng), world.render_depth(T, slam.cam))
    return slam, revisit, T


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    jslam, revisit, T = _revisit_state()
    jax_file, port_file = str(tmp / "jax.npz"), str(tmp / "port.npz")
    JC.save_map(jax_file, jslam)
    port = TSlam(TCFG, device="cpu")
    TC.load_map(jax_file, port)
    TC.save_map(port_file, port)
    jback = JSlam(CFG)
    JC.load_map(port_file, jback)
    return dict(jslam=jslam, port=port, jback=jback, revisit=revisit, T=T,
                jax_file=jax_file, port_file=port_file)


def test_jax_file_loads_into_the_port(cross):
    j, t = cross["jslam"], cross["port"]
    ref = map_state_from_numpy(jax.tree.map(np.asarray, j.map))
    for name in FIELDS:
        x, y = getattr(t.map, name), getattr(ref, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (t.n_kf, t.n_pt, t.ref_kf) == (j.n_kf, j.n_pt, j.ref_kf)
    assert t.culled_chain.keys() == j.culled_chain.keys()
    np.testing.assert_array_equal(t.vocab.words.numpy().view(np.uint32), np.asarray(j.vocab.words))
    np.testing.assert_array_equal(t.vocab.idf.numpy(), np.asarray(j.vocab.idf))
    np.testing.assert_array_equal(t.db.bow.numpy(), np.asarray(j.db.bow))
    np.testing.assert_array_equal(t.db.valid.numpy(), np.asarray(j.db.valid))
    assert t.state == TrackState.NOT_INITIALIZED


def test_port_file_loads_into_jax(cross):
    j, back = cross["jslam"], cross["jback"]
    for name in FIELDS:
        x, y = np.asarray(getattr(back.map, name)), np.asarray(getattr(j.map, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (back.n_kf, back.n_pt, back.ref_kf) == (j.n_kf, j.n_pt, j.ref_kf)
    for name in ("words", "idf"):
        np.testing.assert_array_equal(np.asarray(getattr(back.vocab, name)),
                                      np.asarray(getattr(j.vocab, name)))
    np.testing.assert_array_equal(np.asarray(back.db.bow), np.asarray(j.db.bow))
    np.testing.assert_array_equal(np.asarray(back.db.valid), np.asarray(j.db.valid))


def test_both_files_have_the_same_keys_shapes_and_dtypes(cross):
    with np.load(cross["jax_file"]) as a, np.load(cross["port_file"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
            if key != "meta":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
        for key in WORD_FIELDS:
            assert b[key].dtype == np.uint32, key


def test_both_relocalize_the_revisit_after_a_cross_load(cross):
    """The port on the JAX file and JAX on the port's file, each set LOST
    (the reference fault above), relocalize the same frame to poses within
    POSE_TOL; the rendered camera centre is within 5 cm."""
    img, depth = cross["revisit"]
    port, jback = cross["port"], cross["jback"]
    port.state = TrackState.LOST
    jback.state = JState.LOST
    with jax_sets_injected():
        pt = port.track_rgbd(img, depth, 20.0)
    pj = jback.track_rgbd(img, depth, 20.0)
    assert pt is not None and pj is not None
    assert port.stats["relocs"] == jback.stats["relocs"] == 1
    assert port.state == TrackState.OK and jback.state == JState.OK
    assert port.ref_kf == jback.ref_kf
    np.testing.assert_allclose(pt, np.asarray(pj), atol=POSE_TOL)
    T = cross["T"]
    c_true = -(T[:3, :3].T @ T[:3, 3])
    assert np.linalg.norm(-(pt[:3, :3].T @ pt[:3, 3]) - c_true) < 0.05
