"""The port's fixture writer (``refactored_orb_slam2_tpu_torch/scripts/
make_fixture.py``) against the JAX package's (``scripts/make_fixture.py``,
loaded by path with importlib), on the CPU.

Each package writes the three fixtures of BASELINE.md as ``--frames N``
does (``tum_room`` and ``euroc_hall`` 3 frames, ``kitti_loop`` 2: a
1241x376 street frame takes the port's renderer about 15 s on one CPU
thread), with the generators' own seeds; and the first 3 frames of the
600-frame ``tum_room`` (the port's ``first``, which ``chip_smoke.py``
phase 16 uses) equal the JAX writer's 600-frame trajectory cut to 3.

- The text files (``rgb.txt``, ``depth.txt``, ``groundtruth.txt``,
  ``times.txt``, ``poses/00.txt``) are equal line for line. Only the ground
  truth files may differ by 1e-6 in a value whose last printed digit moved
  (their quaternions come from the port's ``se3.to_quaternion`` in torch
  against JAX's): none did when this test was written, and a failure names
  the file and line.
- The images agree within ``tests/test_torch_world3d.py``'s render
  tolerances: grey levels within 1 on >= 99.5% of the pixels; depth (uint16
  at 5000 per metre, truncated) within 1 unit where both hit (1e-4 m before
  the truncation), the same pixels hit.
- The JAX package's readers (cv2) and the port's (``io/png.py``) read both
  outputs to equal arrays.
- The port's driver runs as a subprocess with ``--cpu`` over the port's
  first 3 ``tum_room`` frames (``--frames 3`` alone would sweep the whole
  orbit in 3 frames, which no tracker follows) in BASELINE.md's mode (``rgbd_tum --variant 3 --coop
  --depth 1``) with ``cv2`` made unimportable in that process, tracks
  every frame, and ``scripts/evaluate.py`` reads its trajectory against the
  fixture's ground truth.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from refactored_orb_slam2_tpu.io import datasets as JD
from refactored_orb_slam2_tpu_torch.io import datasets as TD

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = {"tum_room": 3, "kitti_loop": 2, "euroc_hall": 3}
TEXT = {"tum_room": ["rgb.txt", "depth.txt", "groundtruth.txt"],
        "kitti_loop": ["sequences/00/times.txt", "poses/00.txt",
                       "sequences/00/groundtruth.txt"],
        "euroc_hall": ["mav0/groundtruth.txt"]}
READERS = {"tum_room": [("TumRgbdSequence", ""), ("TumMonoSequence", "")],
           "kitti_loop": [("KittiStereoSequence", "sequences/00"),
                          ("KittiMonoSequence", "sequences/00")],
           "euroc_hall": [("EurocStereoSequence", "mav0"), ("EurocMonoSequence", "mav0")]}


def _jax_make_fixture():
    spec = importlib.util.spec_from_file_location(
        "jax_make_fixture", os.path.join(REPO, "scripts", "make_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """name -> (the port's root, the JAX package's root), written on first use."""
    from refactored_orb_slam2_tpu_torch.scripts import make_fixture as port

    jax_mf, roots = _jax_make_fixture(), {}

    def get(name):
        if name not in roots:
            t = str(tmp_path_factory.mktemp(f"port_{name}"))
            j = str(tmp_path_factory.mktemp(f"jax_{name}"))
            port.FIXTURES[name][0](t, FRAMES[name], device="cpu")
            jax_mf.FIXTURES[name][0](j, FRAMES[name])
            roots[name] = (t, j)
        return roots[name]

    return get


@pytest.fixture(scope="module")
def tum_start(tmp_path_factory):
    """The first 3 frames of the 600-frame tum_room: the port's writer with
    ``first=3``, the JAX writer with its trajectory cut to 3 frames."""
    from refactored_orb_slam2_tpu_torch.scripts import make_fixture as port

    jax_mf = _jax_make_fixture()
    t, j = str(tmp_path_factory.mktemp("port_start")), str(tmp_path_factory.mktemp("jax_start"))
    port.gen_tum_room(t, 600, device="cpu", first=3)
    full = jax_mf.W.traj_room_orbit
    jax_mf.W.traj_room_orbit = lambda *a, **k: full(*a, **k)[:3]
    try:
        jax_mf.gen_tum_room(j, 600)
    finally:
        jax_mf.W.traj_room_orbit = full
    return t, j


def test_first_frames_are_the_start_of_the_full_sequence(tum_start):
    t, j = tum_start
    for rel in TEXT["tum_room"]:
        with open(os.path.join(t, rel)) as f, open(os.path.join(j, rel)) as g:
            assert f.read() == g.read(), rel
    names = _pngs(t)
    assert names == _pngs(j) and len(names) == 6
    for rel in names:
        a = cv2.imread(os.path.join(t, rel), cv2.IMREAD_UNCHANGED).astype(np.int64)
        b = cv2.imread(os.path.join(j, rel), cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert np.abs(a - b).max() <= 1, rel


def _values(line):
    out = []
    for tok in line.split():
        try:
            out.append(float(tok))
        except ValueError:
            out.append(tok)
    return out


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_text_files_agree(written, name):
    t_root, j_root = written(name)
    for rel in TEXT[name]:
        with open(os.path.join(t_root, rel)) as f:
            t_lines = f.read().splitlines()
        with open(os.path.join(j_root, rel)) as f:
            j_lines = f.read().splitlines()
        assert len(t_lines) == len(j_lines) > 0, rel
        n_data = sum(1 for line in t_lines if not line.startswith("#"))
        assert n_data == FRAMES[name], rel
        for k, (a, b) in enumerate(zip(t_lines, j_lines)):
            if a == b:
                continue
            assert rel.endswith("groundtruth.txt"), f"{rel}:{k + 1}: {a!r} != {b!r}"
            va, vb = _values(a), _values(b)
            assert len(va) == len(vb) and all(
                x == y if isinstance(x, str) else abs(x - y) <= 1e-6 + 1e-12
                for x, y in zip(va, vb)), f"{rel}:{k + 1}: {a!r} vs {b!r} beyond 1e-6"


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_images_agree_within_the_render_tolerances(written, name):
    t_root, j_root = written(name)
    names = _pngs(t_root)
    assert names == _pngs(j_root)
    assert len(names) == 2 * FRAMES[name]
    for rel in names:
        t = cv2.imread(os.path.join(t_root, rel), cv2.IMREAD_UNCHANGED).astype(np.int64)
        j = cv2.imread(os.path.join(j_root, rel), cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert t.shape == j.shape
        if rel.startswith("depth"):
            np.testing.assert_array_equal(t > 0, j > 0)
            assert (t > 0).mean() > 0.9
            assert np.abs(t - j)[t > 0].max() <= 1, rel
        else:
            assert (np.abs(t - j) <= 1).mean() >= 0.995, rel


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_both_readers_read_both_outputs(written, name):
    from refactored_orb_slam2_tpu_torch.utils import presets as TP

    for root in written(name):
        for reader, sub in READERS[name]:
            kw = {"depth_factor": TP.get_preset("rgbd_tum3").tracking.depth_map_factor} \
                if reader == "TumRgbdSequence" else {}
            t = list(getattr(TD, reader)(os.path.join(root, sub), **kw))
            j = list(getattr(JD, reader)(os.path.join(root, sub), **kw))
            assert len(t) == len(j) == FRAMES[name]
            for a, b in zip(t, j):
                assert a[0] == b[0] and len(a) == len(b)
                for x, y in zip(a[1:], b[1:]):
                    assert x.dtype == y.dtype == np.float32
                    np.testing.assert_array_equal(x, y)


def test_driver_reads_the_port_fixture_without_cv2(tum_start, tmp_path):
    t_root, _ = tum_start
    flags, _, gt = chip_smoke.FIXTURE_RUNS["tum_room"]
    out = str(tmp_path / "traj.txt")
    argv = [*flags, "--data", t_root, "--cpu", "--out", out]
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "from refactored_orb_slam2_tpu_torch.scripts.run_dataset import main\n"
            f"main({argv!r})\n"
            "assert sys.modules['cv2'] is None\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["mode"] == "rgbd_tum" and summary["frames"] == FRAMES["tum_room"]
    with open(out) as f:
        assert len(f.read().splitlines()) == FRAMES["tum_room"]          # every frame tracked
    ev = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "evaluate.py"),
                         "--est", out, "--gt", os.path.join(t_root, gt), "--json"],
                        capture_output=True, text=True, timeout=120)
    assert ev.returncode == 0, ev.stderr
    r = json.loads(ev.stdout)
    assert r["poses"] == FRAMES["tum_room"] and r["ate_rmse_m"] < 0.01
