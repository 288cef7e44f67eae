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


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tiny_run_on_the_cpu(fault, monkeypatch, capsys):
    torch.set_num_threads(4)
    spec = tiny_spec()
    monkeypatch.setattr(registry, "cell", lambda *a, **kw: spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run_cell = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda *a, **kw: run_cell(*a, **kw, device="cpu"))
    monkeypatch.setattr(harness, "CHECKS_DIR", CHECKS)
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch.setattr)
    rc = run.main(["--workload", "tum_rgbd.desk_orbit", "--seed", str(SEED),
                   "--seconds", "6", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["attempted"] >= 10
    assert err.strip().splitlines()[-1].startswith("check ")
    assert line["correct"] is (fault == "sound"), line["checks"]
