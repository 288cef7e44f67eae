"""The BA across processes (``refactored_orb_slam2_tpu_torch/parallel/
multihost.py``): two port-only ranks under gloo with a ``file://``
rendezvous in the test's own directory (no port to race for under xdist),
each a subprocess with a 120 s timeout, on the JAX multihost worker's
problem (``tests/test_multihost.py``: K 6, P 64, O 4, seed 7).

Checks: the poses equal across ranks within 1e-6; 32 points per rank; the
cameras' translation error falls below half its start (in the worker);
the poses within 5e-4 of the JAX package's single-process ``BA.run`` on
the same arrays; ``host_point_slice`` raising on a remainder.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from refactored_orb_slam2_tpu.geometry.camera import Camera as JCamera
from refactored_orb_slam2_tpu.optim import bundle_adjustment as JBA
from refactored_orb_slam2_tpu_torch.parallel import multihost as MH
from refactored_orb_slam2_tpu_torch.scripts import multihost_ba as W

torch.set_num_threads(1)


def test_two_ranks_under_gloo(tmp_path):
    out = tmp_path / "out"
    W.launch(2, f"file://{tmp_path / 'rendezvous'}", ["cpu", "cpu"], str(out), timeout=120.0)
    poses = [np.load(f"{out}.poses.{r}.npy") for r in range(2)]
    points = [np.load(f"{out}.points.{r}.npy") for r in range(2)]
    np.testing.assert_allclose(poses[0], poses[1], rtol=0, atol=1e-6)
    assert points[0].shape == points[1].shape == (32, 3)

    # the JAX package's BA in one process on the same arrays
    a = W.problem()
    jcam = JCamera.create(W.FX, W.FX, W.CX, W.CY, bf=W.BF, width=320, height=240)
    ref = JBA.run(jcam, JBA.BAProblem(**{k: jnp.asarray(v) for k, v in W.ba_arrays(a).items()}),
                  iters_phase1=6, iters_phase2=0, solver="pcg", n_cg=80)
    np.testing.assert_allclose(poses[0], np.asarray(ref.kf_poses), atol=5e-4)
    np.testing.assert_allclose(np.concatenate(points), np.asarray(ref.points), atol=5e-3)
    err0 = np.linalg.norm(a["poses_noisy"][:, :3, 3] - a["poses"][:, :3, 3])
    err1 = np.linalg.norm(poses[0][:, :3, 3] - a["poses"][:, :3, 3])
    assert err1 < 0.5 * err0


def test_init_process_and_host_point_slice(tmp_path, monkeypatch):
    """One gloo rank in this process: the backend follows the device, the
    mesh names the rank's device and the slice covers the bank; with a
    world of 2 (the group's size and rank patched) rank 1 gets the upper
    half and a remainder raises."""
    MH.init_process(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = MH.global_mesh()
        assert mesh.device == torch.device("cpu") and mesh.axis == "points"
        assert MH.host_point_slice(63) == (0, 63)
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(MH.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(MH.dist, "get_rank", lambda: 1)
    assert MH.host_point_slice(64) == (32, 64)
    with pytest.raises(ValueError, match="63 not divisible by 2"):
        MH.host_point_slice(63)
