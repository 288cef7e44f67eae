"""The run as a checker starts it: no card, no result; and on the CPU, past
the look for a card, a tiny cell's whole run, its last line, and the
verdict it gives when the timed path is broken underneath."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from slambench import faults, harness, registry, run
from slambench.tests.tiny import CHECKS, tiny_spec

SEED = 2**31 + 12345          # seeds may pass 32 signed bits


def test_no_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, "-m", "slambench.run", "--workload",
                           "tum_rgbd.desk_orbit", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=registry.ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


FAULTS = dict(sound=None, **faults.FAULTS)
#: the window of each sensor's tiny run: the monocular one ends a whole pass
#: of 24 frames, the initializer's 4 and mapping on most of the rest
WINDOW_S = {"rgbd": 6, "monocular": 14}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("sensor", sorted(WINDOW_S))
def test_tiny_run_on_the_cpu(sensor, fault, monkeypatch, capsys):
    torch.set_num_threads(4)
    spec = tiny_spec(sensor=sensor)
    monkeypatch.setattr(registry, "cell", lambda *a, **kw: spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run_cell = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda *a, **kw: run_cell(*a, **kw, device="cpu"))
    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch.setattr)
    rc = run.main(["--workload", spec["workload"]["name"], "--seed", str(SEED),
                   "--seconds", str(WINDOW_S[sensor]), "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["attempted"] >= 10
    assert err.strip().splitlines()[-1].startswith("check ")
    assert line["correct"] is (fault == "sound"), line["checks"]
    init = line["readings"]["init_frames"]
    assert isinstance(init, int) and 0 <= init < 24
    if sensor == "monocular":
        assert "init_frames" in line["checks"] and init > 0
        assert line["readings"]["scale"] != 1.0


def test_traced_tiny_run_hands_spans_to_the_readers():
    """A traced run's readings carry the window's spans, counters, frame
    stamps and frame times, which ``host_reads_per_frame`` and
    ``entry.frame_p50_ms`` read; an untraced run never turns the port's
    tracing on, and a traced one turns it off again."""
    from refactored_orb_slam2_tpu_torch.utils import telemetry

    torch.set_num_threads(4)
    spec = tiny_spec()
    telemetry.spans()
    untraced = harness.drive(spec, SEED, 1.0, False, device="cpu")
    assert untraced["readings"] is None and telemetry.spans() == []
    traced = harness.drive(spec, SEED, 3.0, True, device="cpu")
    r = traced["readings"]
    assert len(r["frame_stamps"]) == len(traced["times"])
    assert all(t0 <= t1 for _, t0, t1 in r["frame_stamps"])
    frames = {s["key"] for s in r["spans"] if s["name"] == "frame"}
    assert frames == {fid for fid, _, _ in r["frame_stamps"]}
    assert 0 < len(r["spans"]) < r["span_limit"]
    assert r["counters"]["host_reads"] >= len(traced["times"])
    with telemetry.timer("after the window"):
        pass
    assert telemetry.spans() == []
    metrics = harness.layer_metrics(spec["per_layer"], r)
    assert metrics["host_reads_per_frame"]["value"] == (r["counters"]["host_reads"]
                                                        / len(r["frame_stamps"])) > 0
    assert r["frame_s"] == traced["times"]
    p50 = registry.metric_reader("entry.frame_p50_ms")(r)
    assert p50 == harness.window_metrics(traced["times"])["frame_p50_ms"] > 0
