"""Where the harness finds what a cell names: every configuration, traffic
mix and per-layer metric reader is a file of its own, found by its name.

- a configuration: the JSON file that ``BENCHMARK.json`` gives it;
- a traffic mix: ``traffic/<traffic>.json``, parameters for the one
  generator in ``harness.make_inputs``, which names a scene
  (``scenes/<name>.json``) and a trajectory (``trajectories/<name>.csv``),
  both read by ``world.py``; the configuration's sensor picks the frames
  and the port's entry (``harness.SENSORS``: RGB-D, stereo, monocular);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(readings)``
  returns the metric's value, or None when the run gave it nothing to read.

A later cell, configuration or metric is added as new files and entries,
without an edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The workload entry, its configuration (entry and file), its traffic
    mix, and the metrics it reports: ``end_to_end`` and ``per_layer``
    entries whose ``workloads`` name it or that have no such key."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    mine = lambda m: workload in m.get("workloads", [workload])
    return dict(workload=w, config_entry=entry, config=config,
                traffic=load_traffic(w["traffic"], root / HERE.name / "traffic"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def load_traffic(name: str, base: Path = HERE / "traffic") -> dict:
    with open(base / f"{name}.json") as f:
        return json.load(f)


def metric_reader(name: str, base: Path = HERE / "metrics"):
    """``read`` of ``metrics/<name>.py``."""
    path = base / f"{name}.py"
    spec = importlib.util.spec_from_file_location("slambench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
