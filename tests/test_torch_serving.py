"""The port's serving stack held against the reference's on reduced yi-6b
(and, as parametrised cases, reduced qwen3-moe, jamba, llama4, nemotron-4-15b,
qwen2.5-14b, stablelm-3b and xlstm-1.3b) with converted weights: greedy
tokens and slot accounting; and a serve whose block picks come from a schedule snapshot
republished while it runs (``tests/test_system.py::TestServeHotReload``)."""
import functools

import numpy as np
import jax
import pytest

from repro.configs.base import get_config as jget_config
from repro.launch.engine import greedy_decode_reference as jgreedy
from repro.launch.engine import Request as JRequest
from repro.launch.serve import serve as jserve
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config
from repro_torch.core import tuner
from repro_torch.kernels import ops
from repro_torch.launch.engine import (Request, greedy_decode_reference,
                                       latency_summary)
from repro_torch.launch.serve import group_into_waves, serve
from repro_torch.models.model import Model
from repro_torch.weights import from_jax
from test_torch_models import DENSE_ARCHS, nonzero_norms_and_biases

# (prompt_len, max_new): mixed lengths and budgets, as in test_serving.py
SPEC = [(4, 3), (8, 6), (4, 5), (8, 2), (12, 4), (4, 6), (12, 7)]
CAP = max(p + m for p, m in SPEC) + 2


@pytest.fixture(autouse=True)
def _port_store_off(monkeypatch):
    """The port's default schedule DB and snapshot off around every test."""
    monkeypatch.delenv("REPRO_TUNA_DB", raising=False)
    monkeypatch.delenv("REPRO_TUNA_CACHE", raising=False)
    tuner.set_default_db(None)
    tuner.set_default_cache(None)
    yield
    tuner.set_default_db(None)
    tuner.set_default_cache(None)


def _make_setup(arch, spec=SPEC):
    jmodel = JModel(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.key(0))
    if arch in DENSE_ARCHS:
        jparams = nonzero_norms_and_biases(jparams)
    model = Model(get_config(arch).reduced(), device="cpu")
    params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 256, p)] for p, _ in spec]
    want = {i: jgreedy(jmodel, jparams, pr, m, CAP)
            for i, (pr, (_, m)) in enumerate(zip(prompts, spec))}
    return jmodel, jparams, model, params, prompts, want


@pytest.fixture(scope="module")
def setup():
    return _make_setup("yi_6b")


@pytest.fixture(scope="module",
                params=["qwen3_moe_235b_a22b", "jamba_v01_52b",
                        "llama4_maverick_400b_a17b"])
def arch_setup(request):
    return _make_setup(request.param)


@functools.lru_cache(maxsize=None)
def _dense_setup(arch):
    """One setup per dense arch, shared by its scheduler cases (a module
    fixture would be set up again for a case parametrised apart)."""
    return _make_setup(arch)


def _requests(cls, prompts, spec=SPEC):
    return [cls(i, list(pr), m) for i, (pr, (_, m)) in enumerate(zip(prompts, spec))]


@pytest.mark.parametrize("scheduler,slots", [("continuous", 3), ("wave", 3),
                                             ("continuous", 2)])
def test_scheduler_matches_reference_greedy_and_accounting(setup, scheduler, slots):
    """Token-for-token equal to the reference's one-at-a-time greedy decode,
    and the same engine_steps / slot_steps / wasted_slot_steps as the
    reference's own scheduler on the same requests."""
    _check_scheduler(setup, scheduler, slots)


@pytest.mark.parametrize("scheduler,slots", [("continuous", 3), ("wave", 3)])
def test_scheduler_matches_reference_greedy_new_archs(arch_setup, scheduler, slots):
    """The MoE and hybrid models through both schedulers: mamba states and
    k/v copied into slots, free slots decoding garbage, MoE decode at
    capacity 1."""
    _check_scheduler(arch_setup, scheduler, slots)


def test_port_greedy_reference_matches_new_archs(arch_setup):
    _, _, model, params, prompts, want = arch_setup
    for i, (pr, (_, m)) in enumerate(zip(prompts, SPEC)):
        assert greedy_decode_reference(model, params, pr, m, CAP) == want[i]


@pytest.mark.parametrize("arch,scheduler", [(a, "continuous") for a in DENSE_ARCHS]
                         + [("qwen25_14b", "wave")])
def test_scheduler_matches_reference_greedy_dense_archs(arch, scheduler):
    """Layernorm, squared ReLU and QKV bias (redrawn nonzero) through the
    continuous engine, where the biases enter every decode step's k/v; the
    wave scheduler (lockstep positions) for the arch with QKV bias only."""
    _check_scheduler(_dense_setup(arch), scheduler, 3)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_port_greedy_reference_matches_dense_archs(arch):
    _, _, model, params, prompts, want = _dense_setup(arch)
    for i, (pr, (_, m)) in enumerate(zip(prompts, SPEC)):
        assert greedy_decode_reference(model, params, pr, m, CAP) == want[i]


# xlstm-1.3b: two short prompts (the reference's greedy decode compiles per
# prompt length, and its xLSTM stack is the slowest to compile)
XLSTM_SPEC = [(4, 5), (8, 4)]


@functools.lru_cache(maxsize=None)
def _xlstm_setup():
    return _make_setup("xlstm_13b", XLSTM_SPEC)


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_scheduler_matches_reference_greedy_xlstm(scheduler):
    """The mLSTM and sLSTM states copied into slots and stepped per slot,
    token for token in f32 against the reference's greedy decode, with
    its scheduler's accounting."""
    _check_scheduler(_xlstm_setup(), scheduler, 2, XLSTM_SPEC)


def _check_scheduler(setup, scheduler, slots, spec=SPEC):
    jmodel, jparams, model, params, prompts, want = setup
    reqs = _requests(Request, prompts, spec)
    stats = serve(model, params, reqs, slots=slots, cap=CAP, scheduler=scheduler)
    assert {r.rid: r.out for r in reqs} == want
    jreqs = _requests(JRequest, prompts, spec)
    jstats = jserve(jmodel, jparams, jreqs, slots=slots, cap=CAP,
                    scheduler=scheduler)
    for key in ("engine_steps", "slot_steps", "wasted_slot_steps", "prefills",
                "tokens"):
        assert stats[key] == jstats[key], key
    assert set(stats["ttft_s"]) == {"p50", "p95", "p99", "mean"}
    assert len(stats["requests"]) == len(spec)


def test_port_greedy_reference_matches(setup):
    _, _, model, params, prompts, want = setup
    for i, (pr, (_, m)) in enumerate(zip(prompts, SPEC)):
        assert greedy_decode_reference(model, params, pr, m, CAP) == want[i]


def test_eos_frees_slot_early(setup):
    _, _, model, params, prompts, want = setup
    reqs = [Request(i, list(prompts[1]), 6) for i in range(3)]
    eos = want[1][2]  # cut request 0 at its third emitted token
    reqs[0].eos_id = eos
    stats = serve(model, params, reqs, slots=2, cap=CAP, scheduler="continuous")
    assert reqs[0].out[-1] == eos and len(reqs[0].out) <= 3
    assert reqs[0].out == want[1][: len(reqs[0].out)]
    assert all(len(r.out) == 6 for r in reqs[1:])
    assert stats["prefills"] == 3


def test_deadline_truncates_and_is_counted(setup):
    _, _, model, params, prompts, _ = setup
    reqs = [Request(0, list(prompts[0]), 50, deadline_s=0.0),
            Request(1, list(prompts[0]), 4)]
    stats = serve(model, params, reqs, slots=1, cap=64, scheduler="continuous")
    assert reqs[0].truncated and len(reqs[0].out) == 1
    assert len(reqs[1].out) == 4 and not reqs[1].truncated
    assert stats["deadline_truncations"] == 1


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_stats_keys_match_reference(setup, scheduler):
    """Both schedulers report the reference's stats keys; with no schedule
    cache to reload, ``cache_reloads`` is 0 as in an unhooked reference."""
    jmodel, jparams, model, params, prompts, _ = setup
    stats = serve(model, params, [Request(i, list(prompts[0]), 3) for i in range(4)],
                  slots=2, cap=CAP, scheduler=scheduler)
    jstats = jserve(jmodel, jparams,
                    [JRequest(i, list(prompts[0]), 3) for i in range(4)],
                    slots=2, cap=CAP, scheduler=scheduler)
    assert set(stats) == set(jstats)
    assert stats["cache_reloads"] == jstats["cache_reloads"] == 0


def test_group_into_waves_buckets_by_length():
    reqs = [Request(i, [0] * p, 1) for i, p in enumerate([4, 8, 4, 4])]
    waves = group_into_waves(reqs, slots=2)
    assert [[r.rid for r in w] for w in waves] == [[0, 2], [3], [1]]


def test_latency_summary_percentiles():
    s = latency_summary([0.1] * 99 + [1.0])
    assert s["p50"] == pytest.approx(0.1)
    assert latency_summary([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                                   "mean": 0.0}


def test_unknown_scheduler_rejected(setup):
    _, _, model, params, prompts, _ = setup
    with pytest.raises(ValueError):
        serve(model, params, [Request(0, [1, 2], 1)], slots=1, cap=8,
              scheduler="fifo")


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_republished_snapshot_lands_while_serving(setup, scheduler, tmp_path):
    """The block picks of a cold serve land in an empty DB, which becomes a
    snapshot installed by its ``latest`` pointer. Serving the same requests
    again, the refresh hook republishes the snapshot with one more record
    from inside the serve: the continuous engine sees it at an admission,
    the wave scheduler between waves. The swap is counted, the new record
    is served, every pick is a snapshot hit, and the tokens equal those of
    a serve with no store."""
    from repro_torch.tuna.cache import SnapshotManager
    from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord

    _, _, model, params, prompts, want = setup
    bare = _requests(Request, prompts)
    serve(model, params, bare, slots=2, cap=CAP, scheduler=scheduler)
    assert {r.rid: r.out for r in bare} == want

    path = str(tmp_path / "db.jsonl")
    ops.use_schedule_db(path)
    serve(model, params, _requests(Request, prompts), slots=2, cap=CAP,
          scheduler=scheduler)
    lens = sorted({len(p) for p in prompts})
    assert len(ScheduleDatabase(path)) == len(lens)
    mgr = SnapshotManager(path, str(tmp_path / "snaps"))
    mgr.ensure()
    ops.use_schedule_db(None)
    ops.use_schedule_cache(mgr.latest_path)
    first = tuner.get_default_cache()
    extra = ScheduleRecord(op="matmul[K=8192,M=64,N=64,dtype_bytes=2]",
                           target="gpu_h100", config={"bm": 64, "bn": 64, "bk": 128,
                                                      "double_buffer": True},
                           score=1e-6, meta={"strategy": "exhaustive"})

    def refresh():
        if tuner.get_default_cache() is first:  # republish once, mid-serve
            ScheduleDatabase(path).add(extra)
            mgr.ensure()
        return ops.refresh_schedule_cache()

    reqs = _requests(Request, prompts)
    stats = serve(model, params, reqs, slots=2, cap=CAP, refresh=refresh,
                  scheduler=scheduler)
    assert stats["cache_reloads"] >= 1
    assert {r.rid: r.out for r in reqs} == {r.rid: r.out for r in bare}
    swapped = tuner.get_default_cache()
    assert swapped is not first and swapped.misses == 0
    assert first.hits >= 1 and first.misses == 0
    assert tuner.lookup_best(extra.op, "gpu_h100") == extra


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_serve_cli_refuses_archs_with_a_frontend(arch, capsys):
    """The serve takes tokens only, as the reference's does; the archs whose
    prefill needs stub frames or patches are refused with the entry they
    run through, not failed inside a prefill."""
    from repro_torch.launch import serve as serve_mod

    with pytest.raises(SystemExit) as exc:
        serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert exc.value.code == 2
    assert "Model.prefill" in capsys.readouterr().err
