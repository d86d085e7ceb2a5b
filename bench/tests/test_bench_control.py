"""Each cell's control: the plain reference put in the program's place at
the precision below the configuration's (float8 e4m3 products for bf16)
has to come out not correct.

On the card (``-m gpu``) the control runs at the cell's own size on three
seeds, a short window at the cell's own load, and must read over the
cell's limit; run with ``-s`` it prints each seed's readings, the
program's numbers with their limits beside the control's. On the CPU the
same runs at tiny sizes show the control's number above the program's.
"""
import json

import pytest
import torch

from conftest import small_cell
from harness import cell as C

CELLS = ["yi6b.serve.docqa", "jamba8.serve.chat", "yi6b.ops.tuned_gemm", "yi6b.train.s2048"]


def _control_fails(cell, result) -> bool:
    """Whether the control reads over a limit of one of the cell's numbers."""
    if isinstance(cell.control, dict):   # the train cell: each number's gap
        return any(cell.control[name] > result["checks"][name]["limit"]
                   for name in ("loss_gap", "grad_gap", "change_gap"))
    (name, check), = [(k, v) for k, v in result["checks"].items()
                      if k not in ("unfinished", "weights_moved")]
    return cell.control > check["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        cell = C.Cell(name, seed, 5.0, False, "cuda", overrides={"control": True})
        result = C.execute(cell)
        print(json.dumps({"workload": name, "seed": seed, "checks": result["checks"],
                          "control": cell.control, "correct": result["correct"],
                          "metrics": result["metrics"]}, default=str), flush=True)
        assert result["correct"], result["checks"]
        assert _control_fails(cell, result), (cell.control, result["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program_on_the_cpu(name):
    cell = small_cell(name, seconds=2.0, control=True)
    result = C.execute(cell)
    if isinstance(cell.control, dict):
        assert cell.control["grad_gap"] > result["checks"]["grad_gap"]["value"]
    else:
        (check,) = [v for k, v in result["checks"].items()
                    if k not in ("unfinished", "weights_moved")]
        assert cell.control > check["value"]
