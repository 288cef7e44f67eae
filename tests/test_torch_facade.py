"""The facade calls that drivers make, on the port's synchronous system
(CPU): the sequence of ``bench.py`` (frames, ``flush_pipeline``,
``reset``, frames again, ``flush_pipeline``, ``n_kf``,
``wait_mapping_idle(timeout=60)``, the ``mapper`` check) and of
``scripts/run_dataset.py`` (frames, ``shutdown``), on the
``test_torch_sequence.py`` RGB-D scenario.  None of them waits for
anything: the poses and the map are those of the same frames without the
calls.  ``pipeline_depth`` 1 is accepted; the pipelined and cooperative
modes (and ``pipeline_depth`` 3) track and shut down, and so does the async
mode, its worker threads stopped.
"""

import numpy as np
import pytest
import torch

from refactored_orb_slam2_tpu_torch.system import SlamSystem
from test_torch_sequence import TCFG, lateral_traj, render

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return render(lateral_traj(6))


def _track(slam, frames):
    return [slam.track_rgbd(img, depth, i * 0.1) for i, (img, depth) in enumerate(frames)]


def test_bench_call_sequence(frames):
    slam = SlamSystem(TCFG, device="cpu", pipeline_depth=1)
    plain = SlamSystem(TCFG, device="cpu")
    _track(slam, frames[:3])                 # bench.py's pre-roll
    slam.flush_pipeline()
    slam.reset()
    out = _track(slam, frames)
    slam.flush_pipeline()
    n_kf_end = slam.n_kf
    assert slam.wait_mapping_idle(timeout=60)
    assert slam.mapper is None
    ref = _track(plain, frames)
    assert n_kf_end == plain.n_kf and slam.n_pt == plain.n_pt
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(slam.frame_poses(), plain.frame_poses())


def test_run_dataset_shutdown(frames):
    slam = SlamSystem(TCFG, device="cpu")
    _track(slam, frames)
    n_kf, poses = slam.n_kf, slam.frame_poses()
    slam.shutdown()
    assert slam.n_kf == n_kf and slam.wait_mapping_idle()
    np.testing.assert_array_equal(slam.frame_poses(), poses)


@pytest.mark.parametrize("kw", [dict(pipeline_depth=3), dict(pipelined=True),
                                dict(async_mapping=True), dict(cooperative_mapping=True)])
def test_other_modes_raise_naming_item_12(frames, kw):
    """Every mode of item 12 constructs, tracks 3 frames and shuts down with
    nothing in flight or queued; the async mode's threads are stopped and
    its mapper gone."""
    slam = SlamSystem(TCFG, device="cpu", **kw)
    threads = slam.mapper.threads() if kw.get("async_mapping") else []
    out = _track(slam, frames[:3])
    slam.shutdown()
    assert all(p is not None for p in out) and len(slam.tracked_logs()) == 3
    assert not slam._inflight and not slam._coop_busy() and slam.wait_mapping_idle()
    assert slam.mapper is None and not any(t.is_alive() for t in threads)
    assert len(threads) == (2 if kw.get("async_mapping") else 0)
