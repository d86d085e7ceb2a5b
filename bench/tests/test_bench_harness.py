"""The harness on the CPU: traffic, the closed-loop TTFT, the arithmetic of
work and bounds, the readers, the result line, the cells end to end at tiny
sizes, and a cell added as new files only."""
import json
import math
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, small_cell
from harness import cell as C
from harness import config as c
from harness import traffic, work
from harness.trace import Trace, _union

DOCQA = json.loads((BENCH / "workloads" / "yi6b.serve.docqa.json").read_text())["traffic"]
CHAT = json.loads((BENCH / "workloads" / "jamba8.serve.chat.json").read_text())["traffic"]


# ---------------------------------------------------------------- traffic
@pytest.mark.parametrize("mix", [DOCQA, CHAT], ids=["docqa", "chat"])
def test_traffic_is_the_seeds_and_covers_its_ranges(mix):
    a = traffic.requests(mix, 2**31 + 11, 10, 1000)
    b = traffic.requests(mix, 2**31 + 11, 10, 1000)
    c = traffic.requests(mix, 2**31 + 12, 10, 1000)
    assert a == b and a != c
    assert len(a) == mix["clients"] + round(10 * mix["requests_per_s"])
    for reqs in (a, c):
        p = [len(r.prompt) for r in reqs]
        o = [r.max_new for r in reqs]
        assert mix["prompt_tokens"]["min"] <= min(p) and max(p) <= mix["prompt_tokens"]["max"]
        assert mix["output_tokens"]["min"] <= min(o) and max(o) <= mix["output_tokens"]["max"]
        assert max(p) + max(o) <= mix["cap"]
        assert all(0 <= t < 1000 for r in reqs for t in r.prompt)
    # every seed holds the same lengths, in another order unless the mix fixes it
    lengths = [[(len(r.prompt), r.max_new) for r in reqs] for reqs in (a, c)]
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in c)
    assert (lengths[0] == lengths[1]) == ("order_seed" in mix)


def test_a_clipped_length_is_cut_to_the_window():
    dist = {"dist": "loguniform", "min": 1000, "max": 16000, "clip": 4000}
    q = traffic.quantiles(dist, 8)
    full = traffic.quantiles({k: v for k, v in dist.items() if k != "clip"}, 8)
    assert q == [min(x, 4000) for x in full] and q.count(4000) == 4
    mix = dict(DOCQA, prompt_tokens=dist)
    assert max(len(r.prompt) for r in traffic.requests(mix, 3, 10, 100)) == 4000


def test_a_reader_is_found_by_its_name_or_the_quantity_it_splits():
    assert C.reader_path(ROOT, "mfu.serve").name == "mfu.serve.py"
    assert C.reader_path(ROOT, "device_idle.train").name == "device_idle.py"
    assert C.reader_path(ROOT, "device_idle").name == "device_idle.py"


def test_the_gap_compared_is_the_widest_or_the_mean():
    from harness.serve import gap_name, gap_statistic

    g = torch.tensor([0.0, 0.0, 0.3, 0.1])
    assert gap_statistic(g, {}) == pytest.approx(0.3) and gap_name({}) == "served_gap"
    assert gap_statistic(g, {"gap": "mean"}) == pytest.approx(0.1)
    assert gap_name({"gap": "mean"}) == "served_gap_mean"


def test_the_sample_holds_the_longest_and_enough_requests_and_tokens():
    from harness.serve import sample_requests

    class R:
        def __init__(self, i, p, o):
            self.i, self.prompt, self.out, self.t_done = i, [0] * p, [0] * o, 1.0

    reqs = [R(i, 10 + i, 5) for i in range(20)]
    got = sample_requests(reqs, 12, 6, seed=3)
    assert got[0] is reqs[-1] and len(got) == 6 and len({r.i for r in got}) == 6
    assert len(sample_requests(reqs, 40, 1, seed=3)) == 8


def test_lengths_are_the_distributions_quantiles():
    q = traffic.quantiles({"dist": "loguniform", "min": 100, "max": 10000}, 4)
    want = [round(math.exp(math.log(100) + u * math.log(100))) for u in (0.125, 0.375, 0.625, 0.875)]
    assert q == want
    assert traffic.quantiles({"dist": "uniform", "min": 0, "max": 100}, 2) == [25, 75]


def test_closed_loop_ttft_counts_from_the_completion_it_follows():
    # 2 clients; requests 2 and 3 follow the completions at 1.0 and 1.5
    t_first = [0.1, 0.2, 1.25, 1.55]
    t_done = [1.5, 1.0, 2.0, 2.5]
    assert traffic.closed_loop_ttft(t_first, t_done, 2) == pytest.approx([0.25, 0.05])
    with pytest.raises(ValueError):
        traffic.closed_loop_ttft(t_first, [None, None, None, None], 2)


def test_p95_is_linear_between_order_statistics():
    assert traffic.p95(list(range(101))) == pytest.approx(95.0)
    assert traffic.p95([0.0, 1.0]) == pytest.approx(0.95)


# -------------------------------------------------------------- arithmetic
def test_work_against_hand_counts():
    # causal: 1+2+3 = 6 pairs; q.k and p.v are 2 flops a pair a dim each
    assert work.flash_work(1, 2, 1, 3, 4, True) == (4 * 2 * 4 * 6, (2 * 2 * 3 * 4 + 2 * 1 * 3 * 4) * 2)
    assert work.flash_work(1, 1, 1, 3, 4, False)[0] == 4 * 4 * 9
    assert work.matmul_work(2, 3, 4) == (48, 2 * (8 + 12 + 6))
    s, what = work.bound(989e12, 1.0)
    assert s == pytest.approx(1.0) and what == "operations"
    s, what = work.bound(1.0, 3.35e12)
    assert s == pytest.approx(1.0) and what == "bytes"


def test_model_flops_against_hand_counts():
    c = {"hidden_size": 4, "intermediate_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "num_hidden_layers": 1, "vocab_size": 10}
    # attention 4*(2*2+2*1)*2 = 48 weights, MLP 3*4*8 = 96
    assert work.token_flops(c, 0) == 2 * 144 + 4 * 1 * 2 * 2 * 1
    assert work.prefill_flops(c, 3) == 2 * 144 * 3 + 4 * 2 * 2 * 6 + 2 * 4 * 10
    assert work.decode_flops(c, [0, 1]) == work.token_flops(c, 0) + work.token_flops(c, 1) + 2 * 2 * 40


def test_union_and_gaps():
    busy, gaps = _union([(0, 2), (1, 3), (5, 6)])
    assert busy == 4 and gaps == [(3, 5)]


class _Reading:
    def __init__(self, **kw):
        self.trace = kw.get("trace")
        self.calls = kw.get("calls", {})
        self.spans = kw.get("spans", self.trace)
        self.span_calls = kw.get("span_calls", self.calls)
        self.counters = kw.get("counters", {})
        self.config = kw.get("config", {})
        self.extra = kw.get("extra", {})
        self.work = work


def _read(name, reading):
    return C.load_reader(C.reader_path(ROOT, name))(reading)


YI = {"hidden_size": 4096, "intermediate_size": 11008, "num_attention_heads": 32,
      "num_key_value_heads": 4, "num_hidden_layers": 32, "vocab_size": 64000}


def test_readers_arithmetic():
    s = 2048
    least, _ = work.bound(*work.flash_work(1, 32, 4, s, 128, True))
    flash = [("flash_fwd_wgmma_kernel<...>", 0.0, 1e6 * least * 2)] * 32
    other = [("gemm", 0.0, 1e6)]
    tr = Trace(kernels=flash + other, span_ms={"bench.prefill": 1000.0, "mamba": 500.0},
               span_count={"bench.prefill": 1}, busy_s=0.75, window_s=1.0, gaps=[])
    r = _Reading(trace=tr, calls={"prefills": [s], "decodes": [[10, 20]]}, config=YI)
    assert _read("flash_roofline.serve", r) == pytest.approx(50.0)
    assert _read("device_idle.serve", r) == pytest.approx(25.0)
    assert _read("prefill_ms.serve", r) == pytest.approx(1000.0)
    want = work.prefill_flops(YI, s) + work.decode_flops(YI, [10, 20])
    assert _read("mfu.serve", r) == pytest.approx(100 * want / 989e12)
    assert _read("mfu.prefill", r) == pytest.approx(100 * work.prefill_flops(YI, s) / 989e12)
    assert _read("mamba_share.serve", r) == pytest.approx(100 * 0.5 / tr.kernel_s())
    # launches the tracer dropped: those it kept at the prefills' mean
    r.calls["prefills"] = [s, s]
    assert _read("flash_roofline.serve", r) == pytest.approx(50.0)
    # more launches than the prefills make, or none, read nothing
    r.calls["prefills"] = [s // 2]
    r.trace = Trace(kernels=flash + flash, span_ms={}, span_count={}, busy_s=0.75,
                    window_s=1.0, gaps=[])
    assert _read("flash_roofline.serve", r) is None
    r.trace = Trace(kernels=other, span_ms={}, span_count={}, busy_s=0.75, window_s=1.0, gaps=[])
    assert _read("flash_roofline.serve", r) is None
    assert _read("engine.wasted_slot_share.serve",
                 _Reading(counters={"engine": {"slot_steps": 3, "wasted_slot_steps": 1}})) == 25.0


def test_train_readers_arithmetic():
    least, _ = work.bound(*work.flash_work(2, 32, 4, 2048, 128, True))
    flash = [("flash_fwd_wgmma_kernel<...>", 0.0, 1e6 * least * 4)] * 64
    tr = Trace(kernels=flash, span_ms={"bench.step": 1000.0, "optimizer": 400.0},
               span_count={"bench.step": 1}, busy_s=0.9, window_s=1.0, gaps=[])
    r = _Reading(trace=tr, calls={"steps": [1], "rows": 2, "tokens": 2048}, config=YI)
    assert _read("flash_roofline.train", r) == pytest.approx(25.0)
    assert _read("optimizer_share.train", r) == pytest.approx(100 * 0.4 / tr.kernel_s())
    assert _read("device_idle.train", r) == pytest.approx(10.0)
    assert _read("mfu.train", r) == pytest.approx(100 * work.train_flops(YI, 2, 2048) / 989e12)
    # 6 N T plus the attention, give or take the norms
    n = sum(c.layer_matmul_params(YI, i) for i in range(32)) + 4096 * 64000
    assert work.train_flops(YI, 1, 1) == pytest.approx(6 * n + 3 * 4 * 32 * 32 * 128, rel=1e-9)


def test_ops_readers_arithmetic():
    shapes = [(2, 3, 4), (2, 3, 4)]
    least = sum(work.bound(*work.matmul_work(*s))[0] for s in shapes)
    tr = Trace(kernels=[("matmul_wgmma_kernel", 0.0, 1e6 * least * 4)], span_ms={},
               span_count={}, busy_s=0.5, window_s=1.0, gaps=[])
    r = _Reading(trace=tr, calls={"passes": [1, 1], "shapes": shapes},
                 extra={"oracle": {(2, 3, 4): (2.0, 1.0)}})
    assert _read("matmul_roofline.ops", r) == pytest.approx(50.0)
    assert _read("tuner.pick_over_best.ops", r) == pytest.approx(50.0)
    assert _read("mfu.ops", r) == pytest.approx(100 * 2 * 2 * 48 / 989e12)
    assert _read("device_idle.ops", r) == pytest.approx(50.0)


def test_readers_read_nothing_without_a_device_trace():
    cpu = Trace(kernels=[], span_ms={}, span_count={}, busy_s=0.0, window_s=1.0, gaps=[])
    for name in ("flash_roofline.serve", "mfu.serve", "device_idle.serve", "prefill_ms.serve",
                 "matmul_roofline.ops", "mfu.ops", "device_idle.ops", "mfu.prefill"):
        assert _read(name, _Reading(trace=cpu, calls={"prefills": [8], "passes": [1],
                                                       "shapes": [(2, 3, 4)]})) is None
        assert _read(name, _Reading()) is None


# ------------------------------------------------------------ the cells
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", ["yi6b.serve.docqa", "jamba8.serve.chat", "yi6b.ops.tuned_gemm",
                                  "yi6b.train.s2048"])
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_cell_end_to_end_on_the_cpu(name, trace, monkeypatch):
    from harness import serve

    monkeypatch.setattr(serve, "TRACE_FROM", 2)
    cell = small_cell(name, trace=trace, seconds=2.0)
    result = C.execute(cell)
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    if trace:
        names = {m["name"] for m in C.per_layer_for(cell.bench, name, cell.workload["end_to_end"])}
        assert set(result["metrics"]) <= names
        assert "setup_s" not in result["metrics"]
        assert "breakdown" in result
    else:
        assert set(result["metrics"]) == set(cell.workload["end_to_end"]) | {"setup_s"}
        for m in result["metrics"].values():
            assert m["value"] > 0 and isinstance(m["unit"], str)
        assert "breakdown" not in result
    json.dumps(result)


def test_benchmark_json_names_every_file():
    bench = C.spec()
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).exists()
        raw = json.loads((ROOT / cfg["file"]).read_text())
        assert raw["reduced"] == cfg["reduced"] and raw["source"] == cfg["source"]
    for w in bench["workloads"]:
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        for e2e in wl["end_to_end"]:
            entry = next(m for m in bench["end_to_end"] if m["name"] == e2e)
            assert w["name"] in entry.get("workloads", [w["name"]])
        for m in C.per_layer_for(bench, w["name"], wl["end_to_end"]):
            assert C.reader_path(ROOT, m["name"]).exists()
            assert m["moves"] in wl["end_to_end"]


def test_a_cell_added_as_files_only(tmp_path, monkeypatch):
    """A throwaway cell in a copy of the benchmark: a configuration, a mix
    and a per-layer reader added as new files, and one entry each in the
    copy's BENCHMARK.json; no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "yi-6b.json").read_text())
    cfg.update(name="yi-6b-wide-ffn", intermediate_size=256, reduced=["intermediate_size"])
    (root / "bench" / "configs" / "yi-6b-wide-ffn.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "workloads" / "yi6b.serve.docqa.json").read_text())
    mix["traffic"]["output_tokens"] = {"dist": "uniform", "min": 4, "max": 8}
    (root / "bench" / "workloads" / "wide.serve.short.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "prefills_traced.serve.py").write_text(
        "def read(r):\n    return float(len(r.calls.get('prefills') or [])) or None\n")
    bench["configs"].append({"name": "yi-6b-wide-ffn", "source": cfg["source"],
                             "file": "bench/configs/yi-6b-wide-ffn.json",
                             "reduced": ["intermediate_size"], "why": "a test"})
    bench["workloads"].append({"name": "wide.serve.short", "config": "yi-6b-wide-ffn",
                               "traffic": "short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in mix["end_to_end"]:
            m["workloads"].append("wide.serve.short")
    bench["per_layer"].append({"name": "prefills_traced.serve", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "ttft_p95_s", "workloads": ["wide.serve.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from harness import serve

    monkeypatch.setattr(serve, "TRACE_FROM", 2)
    small = dict(small_cell("yi6b.serve.docqa").overrides)
    small["config"] = {k: v for k, v in small["config"].items() if k != "intermediate_size"}
    timed = C.execute(C.Cell("wide.serve.short", 5, 1.0, False, "cpu", root=root, overrides=small))
    assert timed["correct"] and set(timed["metrics"]) == {"output_tokens_per_s", "ttft_p95_s",
                                                          "setup_s"}
    traced = C.execute(C.Cell("wide.serve.short", 5, 2.0, True, "cpu", root=root, overrides=small))
    assert traced["metrics"]["prefills_traced.serve"]["unit"] == "1"


# ------------------------------------------------------------ the device
def test_the_device_path_raises_without_a_card(monkeypatch):
    from harness import timer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        C.require_cards(1)
    with pytest.raises(RuntimeError):
        timer.replay_seconds(lambda: None, torch.device("cpu"))


def test_run_exits_2_and_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "yi6b.serve.docqa", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "yi6b.serve.docqa",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# ------------------------------------------------------------ isolation
ISOLATION = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
{imports}
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch', 'benchmarks'}}))
"""


@pytest.mark.parametrize("imports,allowed", [
    ("import harness.cell, harness.serve, harness.ops, harness.trace, harness.timer, "
     "harness.work, harness.weights, harness.traffic, harness.config\n"
     "import reference.decoder, reference.matmul\n"
     "from harness import cell\n"
     "cell.Cell('yi6b.serve.docqa', 1, 1.0, False, 'cpu')\n"
     "import repro_torch.launch.serve, repro_torch.kernels.ops, repro_torch.launch.steps, "
     "repro_torch.core.spaces", ["repro_torch"]),
    ("import reference.decoder, reference.matmul", []),
], ids=["harness", "reference"])
def test_nothing_imports_jax_or_the_jax_package(imports, allowed):
    code = ISOLATION.format(bench=str(BENCH), src=str(ROOT / "src"), imports=imports)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().replace("'", '"')) == allowed
