"""Where ``chip_smoke.py`` takes its ATE bounds from: the JAX package on the
CPU over the smoke script's own sequences, at their full width (marked slow:
minutes each; run with ``python -m pytest -m slow
tests/test_torch_smoke_reference.py -s``).

Each case renders the script's frames with the port's renderer on the CPU
(``chip_smoke.render_frames``: the room orbit, one noise generator in
order), feeds them to a JAX ``SlamSystem`` with the script's configuration,
synchronous mapping, loop closing off, and holds the script's ``JAX_*``
constant to the ATE it measures (within 5%: another CPU's float order may
move it a little).  It prints frames tracked, n_kf, n_pt and the ATE, which
PERF.md quotes as "JAX on the CPU".
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from refactored_orb_slam2_tpu.system import SlamSystem as JSlam
from refactored_orb_slam2_tpu.utils import config as j_config

CASES = {
    "rgbd": (chip_smoke.rgbd_config, "JAX_ATE_M"),
    "stereo": (chip_smoke.stereo_config, "JAX_STEREO_ATE_M"),
    "monocular": (chip_smoke.mono_config, "JAX_MONO_ATE_M"),
}


def reference_config(cfg):
    """The JAX package's config tree from the port's, by class and field name."""
    cls = getattr(j_config, type(cfg).__name__)
    return cls(**{f.name: (reference_config(v) if dataclasses.is_dataclass(v) else v)
                  for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]})


@pytest.mark.slow
@pytest.mark.parametrize("sensor", sorted(CASES))
def test_jax_reference_run_gives_the_smoke_constant(sensor):
    make_cfg, constant = CASES[sensor]
    cfg = make_cfg()
    poses = chip_smoke.smoke_poses()
    frames = [tuple(t.numpy() for t in f) for f in chip_smoke.render_frames(cfg, poses, "cpu")]
    slam = JSlam(reference_config(cfg))
    slam.loop_closing_enabled = False
    entry = {"rgbd": slam.track_rgbd_device, "stereo": slam.track_stereo_device,
             "monocular": slam.track_monocular_device}[sensor]
    out = [entry(*frame, i / cfg.camera.fps) for i, frame in enumerate(frames)]
    tracked = [p is not None for p in out]
    first = tracked.index(True)
    gt = chip_smoke.gt_centres(poses)[slam.tracked_frame_ids()]
    ate = (chip_smoke.ate_rmse_sim3 if sensor == "monocular" else chip_smoke.ate_rmse)(
        slam.camera_centers(), gt)
    kf_frames = np.asarray(slam.map.kf_frame_id)[:slam.n_kf].tolist()
    print(f"\nJAX on the CPU, {sensor}: {sum(tracked)}/{len(frames) - first} tracked from "
          f"frame {first}, n_kf {slam.n_kf} at frames {kf_frames}, n_pt {slam.n_pt}, "
          f"culled {sorted(slam.culled_chain)}, ATE {ate:.7f} m, paths {slam.stats}")
    assert sum(tracked) >= 0.9 * (len(frames) - first)
    assert abs(ate - getattr(chip_smoke, constant)) <= 0.05 * ate
