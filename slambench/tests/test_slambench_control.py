"""On the card, at each cell's own size: a sound run is correct; the
control, the reference put in the program's place and computed in
bfloat16, is not; nor is a run with a planted fault (``faults.py``): a
state left unchanged, or every second frame left out.  Skips without a
card; run it there with ``python3 -m pytest -q
slambench/tests/test_slambench_control.py``.  The limits' readings over
many seeds come from ``python3 -m slambench.control``."""

from __future__ import annotations

import pytest
import torch

from slambench import control, registry

SEED = 2**31 + 7
WORKLOADS = [w["name"] for w in registry.load_benchmark()["workloads"]]
#: long enough for a whole pass of either cell: its numbers are compared
SOUND_SECONDS = 45.0
FAULT_SECONDS = 10.0


@pytest.fixture
def spec(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return registry.cell(registry.load_benchmark(), request.param)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", WORKLOADS, indirect=True)
def test_sound_run_is_correct_and_the_bfloat16_control_is_not(spec):
    lines = {line["kind"]: line for line in control.readings(spec, SEED, SOUND_SECONDS)}
    assert lines["sound"]["correct"], lines["sound"]["checks"]
    assert not lines["bf16"]["correct"], lines["bf16"]["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["frozen_state", "half_skipped"])
@pytest.mark.parametrize("spec", WORKLOADS, indirect=True)
def test_a_planted_fault_is_not_correct(spec, fault):
    (line,) = control.readings(spec, SEED, FAULT_SECONDS, fault)
    assert not line["correct"], line["checks"]
