"""The benchmark's CPU tests: ``python -m pytest -q bench/tests`` from the
root of the checkout (``-m gpu`` runs the ones that need a card there).

The harness runs on the CPU here at tiny sizes: the configuration's widths
and the traffic shrunk through ``Cell``'s overrides, the kernels' plain
versions in place of the CUDA ones.
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (BENCH, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

# widths of a CPU rehearsal (the layer counts are each cell's own)
SMALL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 2, "vocab_size": 256, "mamba_dt_rank": 4}
SMALL_LAYERS = {"yi6b.serve.docqa": 2, "jamba8.serve.chat": 8, "yi6b.ops.tuned_gemm": 2,
                "yi6b.train.s2048": 2}
SMALL_WORKLOAD = {
    "serve": {"traffic": {"clients": 4, "prompt_tokens": {"dist": "loguniform", "min": 8, "max": 24},
                          "output_tokens": {"dist": "uniform", "min": 2, "max": 6}, "cap": 32,
                          "requests_per_s": 2.0},
              "check": {"served_tokens": 16}},
    "ops": {"products": {"rows": [16, 4]}},
    "train": {"batch": {"rows": 2, "tokens": 16},
              "optimizer": {"state_dtype": "float32"}},
}
# the train cell rehearses in f32: its limits are set for bf16 at the cell's
# size, where a step's rounding is spread over far more elements
SMALL_CONFIG_EXTRA = {"yi6b.train.s2048": {"torch_dtype": "float32"}}


def small_cell(name, seed=2**31 + 7, seconds=1.0, trace=False, root=ROOT, **extra):
    """The cell ``name`` at CPU size (``extra`` goes into the overrides)."""
    import json

    from harness import cell as C

    kind = json.loads((root / "bench" / "workloads" / f"{name}.json").read_text())["kind"]
    over = {"config": dict(SMALL, num_hidden_layers=SMALL_LAYERS.get(name, 2),
                           **SMALL_CONFIG_EXTRA.get(name, {})),
            "workload": SMALL_WORKLOAD[kind]}
    over.update(extra)
    return C.Cell(name, seed, seconds, trace, "cpu", root=root, overrides=over)


@pytest.fixture
def cpu_cell():
    return small_cell
