"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (configuration, traffic mix,
metrics) comes from ``BENCHMARK.json`` and the files it names.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the reference compared, beside its limit.
The same numbers end standard error.

It exits 2 with no result when there is no CUDA card, or fewer than the
cell asks for, and 3 when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that must not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "refactored_orb_slam2_tpu")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".slambench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _finite(x):
    """JSON has no infinity or NaN: such a reading prints as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from slambench import registry

    spec = registry.cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    _caches()
    import torch

    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {args.workload} needs {chips} CUDA card(s), this machine has {n}; "
              "the benchmark measures the port on the card and has no CPU mode",
              file=sys.stderr)
        return 2
    from slambench import harness

    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              t_start=_T_START)
    found = forbidden_loaded()
    if found:
        print(f"slambench: loaded in this process once the window closed: {found}",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
