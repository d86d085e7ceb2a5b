#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch/CUDA port).

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell ``NAME`` is an entry of
``BENCHMARK.json``'s ``workloads``; its traffic, configuration and
per-layer readers are found by name under ``bench/`` (``workloads/``,
``configs/``, ``metrics/``). The last line of standard output is one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` a ``breakdown``); the numbers that decide
``correct`` are the last lines of standard error. Without a CUDA card (or
with fewer cards than the cell asks for) it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout, the tuner with no stored
    schedules, and no JAX pulled in by a library: set before torch loads."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in ("REPRO_TUNA_DB", "REPRO_TUNA_CACHE", "REPRO_TUNA_BUNDLE",
                 "REPRO_TUNA_LEARNED"):
        os.environ.pop(name, None)
    for path in (BENCH, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from harness import cell

    return cell.main(args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
