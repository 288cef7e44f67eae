"""A cell of the benchmark cut to a size the CPU runs in seconds: half the
camera's resolution, 500 features, a 64 x 8192 x 16 map, 16 frames a pass.
Its monocular variant keeps the configuration's 1000 features and runs 24
frames a pass: with 500 at half resolution the two-view initializer takes
17 frames and starts a wrong map (PERF.md).  Only for the tests: the
benchmark's cells run at their files' sizes."""

from __future__ import annotations

from pathlib import Path

from slambench import registry

CHECKS = Path(__file__).resolve().parent / "data" / "checks"


def tiny_spec(workload: str = "tum_rgbd.desk_orbit", sensor: str = "rgbd") -> dict:
    """The tiny cell of ``workload``; with ``sensor``, its configuration
    with that sensor, named ``tum_mono.desk_orbit`` for a monocular one."""
    spec = registry.cell(registry.load_benchmark(), workload)
    system = spec["config"]["system"]
    cam = system["camera"]
    for key in ("fx", "fy", "cx", "cy", "bf"):
        cam[key] = cam[key] / 2
    cam["width"] //= 2
    cam["height"] //= 2
    system["orb"]["n_features"] = 500
    system["map"].update(max_keyframes=64, max_points=8192, max_obs_per_point=16)
    spec["traffic"].update(first=16, warmup_frames=6, trace_frames=[8, 11],
                           checked_frames={"count": 2, "among_first": 10},
                           checked_eager_calls={"count": 3, "among_first": 8})
    if sensor == "monocular":
        system.update(sensor=sensor)
        system["orb"]["n_features"] = 1000
        spec["traffic"].update(first=24)
        spec["workload"] = dict(spec["workload"], name="tum_mono.desk_orbit", config="tum_mono")
    return spec
