"""Each cell's comparison sees a fault planted in the timed path: the rest
of a run (past the harness's look for a card) on the CPU at tiny sizes,
with the program broken underneath, must come out ``correct`` false."""
import pytest
import torch

from conftest import small_cell
from harness import cell as C


def _decode_fault(kind):
    """A ``Model.decode_step`` broken in one way."""
    from repro_torch.models.model import Model

    real = Model.decode_step

    def step(self, params, cache, token, pos):
        if kind == "state_unchanged":
            saved = [{k: v.clone() for k, v in c.items()} for c in cache]
            logits, cache = real(self, params, cache, token, pos)
            for live, old in zip(cache, saved):
                for k in live:
                    live[k].copy_(old[k])
            return logits, cache
        logits, cache = real(self, params, cache, token, pos)
        if kind == "token_altered":    # each row's worst token put first
            worst = logits.argmin(-1)
            logits = logits.clone()
            logits[torch.arange(logits.shape[0]), worst] = logits.max() + 1.0
        elif kind == "half_the_rows":   # the second half of the slots not computed
            half = logits.shape[0] // 2
            logits = logits.clone()
            logits[half:] = logits[:half][: logits.shape[0] - half]
        return logits, cache

    return step


@pytest.mark.parametrize("name", ["yi6b.serve.docqa", "jamba8.serve.chat"])
@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged", "half_the_rows"])
def test_serve_cells_catch(name, fault, monkeypatch):
    from repro_torch.models.model import Model

    monkeypatch.setattr(Model, "decode_step", _decode_fault(fault))
    result = C.execute(small_cell(name, seconds=4.0))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_rows"])
def test_ops_cell_catches(fault, monkeypatch):
    from repro_torch.kernels import ops

    real = ops.matmul

    def matmul(x, y, **kw):
        out = real(x, y, **kw)
        if fault == "answer_altered":
            out = out.clone()
            out[0, 0] += out.abs().max()
        else:
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(ops, "matmul", matmul)
    result = C.execute(small_cell("yi6b.ops.tuned_gemm"))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
def test_train_cell_catches(fault, monkeypatch):
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    if fault == "state_unchanged":
        monkeypatch.setattr(adamw, "apply_updates",
                            lambda cfg, params, grads, state, lr_scale=1.0:
                            (params, state, {"grad_norm": torch.zeros(())}))
    else:
        real = Model.loss

        def loss(self, params, batch):
            half = batch["tokens"].shape[0] // 2
            return real(self, params, {k: v[:half] for k, v in batch.items()})

        monkeypatch.setattr(Model, "loss", loss)
    result = C.execute(small_cell("yi6b.train.s2048"))
    assert result["correct"] is False, result["checks"]
