"""One run of one cell: find its files by name, check the device, run the
cell's kind, read the per-layer metrics and print the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric sits in a file of its own, found by the names in ``BENCHMARK.json``:
``bench/configs/<file>`` (the entry's ``file``), ``bench/workloads/<cell>.json``
(its ``kind``, traffic, end-to-end metrics and limits) and
``bench/metrics/<metric>.py`` (a ``read(reading)`` that returns the value, or
None where its cell has nothing to read; ``reader_path``). A kind is a
module of this package (``serve``, ``ops``, ``train``).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from harness import config as C

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def per_layer_for(bench: Dict, cell: str, end_to_end: List[str]) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in end_to_end)]


def reader_path(root: Path, name: str) -> Path:
    """``bench/metrics/<name>.py``, or where there is none the reader of the
    quantity it splits by the end-to-end metric it moves
    (``device_idle.serve`` -> ``device_idle.py``)."""
    metrics = root / "bench" / "metrics"
    own = metrics / f"{name}.py"
    if own.exists() or "." not in name:
        return own
    return metrics / f"{name.rsplit('.', 1)[0]}.py"


def load_reader(path: Path):
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: object = "cuda"
    root: Path = ROOT
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    overrides: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        import torch

        self.device = torch.device(self.device)
        self.bench = spec(self.root)
        entry = next((w for w in self.bench["workloads"] if w["name"] == self.name), None)
        if entry is None:
            raise KeyError(f"no cell {self.name!r} in BENCHMARK.json")
        self.entry = entry
        cfg_entry = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        self.config = C.load(self.root / cfg_entry["file"])
        self.config.update(self.overrides.get("config", {}))
        self.workload = json.loads(
            (self.root / "bench" / "workloads" / f"{self.name}.json").read_text())
        for key, val in self.overrides.get("workload", {}).items():
            self.workload[key] = {**self.workload[key], **val} \
                if isinstance(val, dict) else val
        self.arch = C.arch_config(self.config)
        self.t_window: Optional[float] = None
        self.t_closed: Optional[float] = None

    # -- the pieces a kind calls ------------------------------------------
    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_open(self) -> None:
        self.sync()
        self.t_window = time.perf_counter()

    def window_closed(self) -> None:
        self.sync()
        self.t_closed = time.perf_counter()

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.device)
        torch.cuda.empty_cache()
        return int(peak)

    def stretches(self):
        """The run's traced stretches (none without ``trace``)."""
        from harness.trace import Stretches

        return Stretches(self.device, self.root / "build" / "bench" / f"trace-{self.name}.json",
                         self.trace)


def require_cards(chips: int) -> None:
    """Raise where there is no CUDA card or fewer than ``chips``: the
    benchmark measures the card only, and never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(cell: Cell) -> Dict:
    """Run the cell's kind and assemble the result line (a dict)."""
    import torch

    kind = importlib.import_module(f"harness.{cell.workload['kind']}")
    out = kind.run(cell)
    checks = {name: {"value": v, "limit": lim} for name, (v, lim) in out["checks"].items()}
    correct = all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else cell.device.type),
              "count": cell.entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    metrics = {}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if not cell.trace:
        for name in cell.workload["end_to_end"]:
            value, unit = out["metrics"][name]
            metrics[name] = {"value": value, "unit": unit}
        metrics["setup_s"] = {"value": cell.t_window - cell.t_start, "unit": "s"}
    else:
        reading = Reading(cell, out)
        for m in per_layer_for(cell.bench, cell.name, cell.workload["end_to_end"]):
            value = load_reader(reader_path(cell.root, m["name"]))(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr, sp = reading.trace, reading.spans
        if tr is not None:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.top_ops()],
                                   "idle_gaps": [[n, s] for n, s in (sp or tr).gaps]}
    result["checks"] = checks
    return result


class Reading:
    """What a per-layer reader sees: the device's traced stretch (``trace``,
    None where nothing was traced) and the calls recorded in it
    (``calls``), the stretch with the host's ranges (``spans``,
    ``span_calls``), the program's counters, the configuration file's keys
    and the arithmetic."""

    def __init__(self, cell: Cell, out: Dict):
        from harness import work

        r = out.get("reading") or {}
        self.trace = r.get("trace")
        self.calls = r.get("calls") or {}
        self.spans = r.get("spans")
        self.span_calls = r.get("span_calls") or {}
        self.counters = out.get("counters", {})
        self.config = cell.config
        self.work = work
        self.extra = out.get("extra", {})


def main(name: str, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    bench = spec()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        print(f"no cell {name!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    try:
        require_cards(entry["chips"])
    except RuntimeError as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    cell = Cell(name, seed, seconds, trace, "cuda", t_start=t_start)
    result = execute(cell)
    found = forbidden_modules()
    if found:
        print(f"[bench] modules of the JAX package or JAX loaded: {found}", file=sys.stderr)
        return 3
    print(f"[bench] correct = {result['correct']}", file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"[bench] check {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
