"""The readings behind each limit of ``checks/<cell>.json``: sound runs of
the program, the control and planted faults, in one process on the card at
the cell's own size.

    python3 -m slambench.control --workload <cell> --seconds <s> \\
        --seeds 11 12 13 [--fault half_skipped --fault-seeds 31 32 33] [--out FILE]

Each seed is one run of the benchmark (``harness.drive``), judged by
``harness.judge`` as the program produced it ("sound") and once for each
precision below the configuration's (float32 with TF32 off, which
``SlamSystem`` pins): the control, the reference put in the program's place
and computed in TF32, then in bfloat16.  The control's pass is the
rendered ground truth, every frame's pose (each frame also a keyframe) and
points drawn from the seed on the scene's surfaces, rounded to that
precision; its matcher answers are the plain best-2 of each checked call's
own inputs with the window test in that precision.  For a monocular
configuration the pass is first put in a map unit drawn from the seed, a
power of two, so that it goes through the similarity alignment and rounds
as it would at unit scale.  A fault
(``faults.py``) is planted under runs of its own.  One JSON line per
reading: its seed, what was judged, ``correct``, the readings and the
checks.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from slambench import faults, harness, reference, registry

#: explicit mantissa bits of each precision below float32
PRECISIONS = {"tf32": 10, "bf16": 7}
POINTS_PER_SURFACE = 500


class Patches:
    """Attributes replaced until ``undo``."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def map_unit(seed: int) -> float:
    """A monocular control's map unit in metres: 2**k, k in -3..3 but 0,
    drawn from the seed.  A power of two scales every float exactly, so the
    control rounds as at unit scale."""
    k = int(np.random.default_rng([seed, 1]).choice([-3, -2, -1, 1, 2, 3]))
    return 2.0 ** k


def control_pass(inputs: dict, bits: int, seed: int, unit: float = 1.0) -> dict:
    """The reference's pass in the program's place, in a map whose unit is
    ``unit`` metres, rounded to ``bits``."""
    rng = np.random.default_rng(seed)
    points = np.concatenate([s.p0 + np.outer(rng.random(POINTS_PER_SURFACE), s.eu)
                             + np.outer(rng.random(POINTS_PER_SURFACE), s.ev)
                             for s in inputs["surfaces"]])
    Tcw = np.array(inputs["Tcw"], np.float32)
    Tcw[:, :3, 3] /= unit
    Tcw = reference.round_mantissa(Tcw, bits)
    n = len(Tcw)
    return dict(ts=inputs["stamps"], Tcw=Tcw, kf_frame=np.arange(n), kf_Tcw=Tcw,
                points=reference.round_mantissa(points / unit, bits), fed=n, init=0,
                logged=n, lost=0, complete=True)


def control_calls(calls: list, bits: int) -> list:
    """Each checked call with the plain best-2 of its own inputs, the window
    test rounded to ``bits``, in place of the kernel's answer."""
    out = []
    for c in calls:
        a = c["args"]
        if c["name"] == "window_match":
            rows, cols = reference.window_candidates(*a[2:], c["band"], bits=bits)
        else:
            rows, cols = np.nonzero(np.asarray(a[2], bool))
        out.append(dict(c, out=list(reference.best2(a[0], a[1], rows, cols, len(a[0])))))
    return out


def _line(seed, kind, verdict, **extra) -> dict:
    return dict(seed=seed, kind=kind, correct=verdict["correct"], **extra,
                **verdict["readings"], checks=verdict["checks"])


def readings(spec, seed: int, seconds: float, fault: str | None = None) -> list:
    """One run's readings: with ``fault`` planted, that fault's; else the
    sound program's and each precision's control."""
    name = spec["workload"]["name"]
    patches = Patches()
    if fault:
        faults.FAULTS[fault](patches)
    try:
        run = harness.drive(spec, seed, seconds, False)
    finally:
        patches.undo()
    passes, inputs, calls = run["passes"], run["inputs"], run["calls"]
    sensor = spec["config"]["system"]["sensor"]
    unit = map_unit(seed) if sensor == "monocular" else 1.0
    lines = [_line(seed, fault or "sound", harness.judge(passes, inputs, calls, name, sensor),
                   attempted=len(run["times"]), failed=harness.failed_frames(passes, sensor),
                   metrics=harness.window_metrics(run["times"]))]
    if not fault:
        for kind, bits in PRECISIONS.items():
            verdict = harness.judge([control_pass(inputs, bits, seed, unit)], inputs,
                                    control_calls(calls, bits), name, sensor)
            lines.append(_line(seed, kind, verdict))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("slambench.control: no CUDA card", file=sys.stderr)
        return 2
    spec = registry.cell(registry.load_benchmark(), args.workload)
    runs = [(s, None) for s in args.seeds] + [(s, args.fault) for s in args.fault_seeds
                                              if args.fault]
    for seed, fault in runs:
        t0 = time.perf_counter()
        for line in readings(spec, seed, args.seconds, fault):
            text = json.dumps(dict(line, workload=args.workload,
                                   run_s=time.perf_counter() - t0), default=float)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
