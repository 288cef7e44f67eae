"""Where ``chip_smoke.py`` takes its ATE and relocalization bounds from: the
JAX package on the CPU over the smoke script's own sequences, at their full
width (marked slow: minutes each; run with ``python -m pytest -m slow
tests/test_torch_smoke_reference.py -s``).

Each case renders the script's frames with the port's renderer on the CPU
(``chip_smoke.render_frames``: the room orbit, one noise generator in
order), feeds them to a JAX ``SlamSystem`` with the script's configuration,
synchronous mapping, loop closing off, and holds the script's ``JAX_*``
constant to the ATE it measures (within 5%: another CPU's float order may
move it a little).  Then it runs the script's phase 9 on the same system:
for RGB-D first phase 6 (localization-only over the last 40 frames in
reverse order), then two grey frames and the path's orbit frames
(``chip_smoke.reloc_episode``), and for RGB-D once more in
localization-only mode.  It holds ``chip_smoke.JAX_RELOC`` to the frame that
relocalized and the camera centre's distance from the rendered one (within
5% or 0.1 mm).  It prints frames tracked, n_kf, n_pt, the ATE and each
relocalization, which PERF.md quotes as "JAX on the CPU".
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


def _reloc(slam, track, frames, grey, path, t0, gt, align):
    """One phase-9 episode on the JAX system; returns (frame of the orbit
    that relocalized or None, centre error there, orbit frames after it
    tracked, state after the grey frames, relocs, reloc_rejects)."""
    states = []

    def tracked(f, i):
        out = track(f, i)
        states.append(slam.state)
        return out

    relocs = slam.stats["relocs"]
    out = chip_smoke.reloc_episode(tracked, frames, grey, path, t0)
    steps = list(chip_smoke.RELOC_STEPS[path])
    hit = next((k for k, p in enumerate(out[2:]) if p is not None), None)
    if hit is None:
        return None, None, 0, states[1], slam.stats["relocs"] - relocs, slam.stats["reloc_rejects"]
    err = chip_smoke.centre_error(out[2 + hit], gt[steps[hit]], align)
    after = sum(p is not None for p in out[3 + hit:])
    return (steps[hit], err, after, states[1], slam.stats["relocs"] - relocs,
            slam.stats["reloc_rejects"])


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
    gt = chip_smoke.gt_centres(poses)
    est, gt_run = slam.camera_centers(), gt[slam.tracked_frame_ids()]
    mono = sensor == "monocular"
    ate = (chip_smoke.ate_rmse_sim3 if mono else chip_smoke.ate_rmse)(est, gt_run)
    kf_frames = np.asarray(slam.map.kf_frame_id)[:slam.n_kf].tolist()
    print(f"\nJAX on the CPU, {sensor}: {sum(tracked)}/{len(frames) - first} tracked from "
          f"frame {first}, n_kf {slam.n_kf} at frames {kf_frames}, n_pt {slam.n_pt}, "
          f"culled {sorted(slam.culled_chain)}, ATE {ate:.7f} m, paths {slam.stats}")
    assert sum(tracked) >= 0.9 * (len(frames) - first)
    assert abs(ate - getattr(chip_smoke, constant)) <= 0.05 * ate

    # phase 9 (after phase 6 for RGB-D), on the same system
    track = lambda f, i: entry(*f, i / cfg.camera.fps)
    t0 = len(frames)
    if sensor == "rgbd":
        slam.activate_localization_mode()
        for k, i in enumerate(range(len(frames) - 1, len(frames) - 1 - chip_smoke.N_LOCALIZATION, -1)):
            assert track(frames[i], t0 + k) is not None
        slam.deactivate_localization_mode()
        t0 += chip_smoke.N_LOCALIZATION
    grey = tuple(t.numpy() for t in chip_smoke.grey_frame(cfg, "cpu"))
    align = chip_smoke.sim3_alignment(est, gt_run) if mono else None
    paths = {"rgbd": ["rgbd", "localization"], "stereo": ["stereo"],
             "monocular": ["monocular"]}[sensor]
    for path in paths:
        if path == "localization":
            slam.activate_localization_mode()
        map_size = (slam.n_kf, slam.n_pt)
        frame, err, after, state, relocs, rejects = _reloc(
            slam, track, frames, grey, path, t0, gt, align)
        t0 += 2 + len(chip_smoke.RELOC_STEPS[path])
        print(f"JAX on the CPU, phase 9 {path}: state {state} after the grey frames, "
              f"relocalized at orbit frame {frame}, centre error "
              f"{'-' if err is None else f'{err:.7f}'} m, {after} orbit frames after it "
              f"tracked, relocs {relocs}, reloc_rejects {rejects}, n_kf {map_size[0]} -> "
              f"{slam.n_kf}, n_pt {map_size[1]} -> {slam.n_pt}")
        if path not in chip_smoke.JAX_RELOC:      # no constant yet: print only
            continue
        expect = chip_smoke.JAX_RELOC[path]
        if expect is None:
            assert frame is None, path
            continue
        assert state == 2 and frame == expect[0] and relocs == 1, path
        assert after == len(chip_smoke.RELOC_STEPS[path]) - 1 - (frame - chip_smoke.RELOC_STEPS[path][0])
        assert abs(err - expect[1]) <= max(0.05 * err, 1e-4), (path, err)
        if path == "localization":
            assert (slam.n_kf, slam.n_pt) == map_size
