"""The port's static analysis (``repro_torch.core``) held against the
reference's (``repro.core``), and the port's Hopper target and matmul space.

The port keeps its own copies of the reference's TPU, CPU and A100
targets (``repro_torch.hw``): the tests require them equal to the
reference's field by field, then exactly equal knobs, signatures,
enumeration order, VISA text, features, scores, rankings and ES results,
for the four legacy families and the model zoo's ``moe_dispatch``,
``ssm_scan`` and ``mlstm_chunk`` on every kind of the reference.
"""
import dataclasses
import itertools
import json
import random

import torch

import numpy as np
import pytest

from repro.core import cost_model as jcost_model
from repro.core import es as jes
from repro.core import op_registry as jop_registry
from repro.core import tuner as jtuner
from repro.core import visa as jvisa
from repro.hw import TARGETS as JTARGETS
from repro_torch.benchmarks import topk_ratio
from repro_torch.core import cost_model, es, op_registry, tuner, visa
from repro_torch.core.spaces import SM90_MATMUL_TILES, MatmulSpace, sm90_matmul_smem_bytes
from repro_torch.hw import TARGET_NAMES, get_target
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.hw.target import HardwareTarget

YI6B_SHAPES = ((2048, 4096, 4096), (2048, 512, 4096), (2048, 11008, 4096),
               (2048, 4096, 11008), (2048, 64000, 4096))
LEGACY = ("matmul", "batch_matmul", "conv2d", "depthwise_conv2d")
ZOO = ("moe_dispatch", "ssm_scan", "mlstm_chunk")


def _port_target(ref) -> HardwareTarget:
    """The port's own copy of a reference target (held equal to it by
    ``test_reference_targets_are_copied_field_by_field``)."""
    return get_target(ref.name)


TARGET_FOR_KIND = {"tpu": ("tpu_v5e",), "cpu": ("cpu_avx2", "gpu_a100"),
                   "gpu": ("gpu_a100",)}

# (family, attrs, kind): every legacy preset on its kind, every zoo preset of
# the reference's on each of its kinds, plus a few shapes
CASES = [(fam, dict(p.attrs), p.kind)
         for _, (fam, p) in jop_registry.all_presets().items() if fam in LEGACY]
CASES += [(fam, dict(p.attrs), kind)
          for _, (fam, p) in jop_registry.all_presets().items() if fam in ZOO
          for kind in ("tpu", "cpu", "gpu")]
CASES += [
    ("matmul", {"M": 256, "N": 384, "K": 128, "dtype_bytes": 2}, "tpu"),
    ("matmul", {"M": 96, "N": 64, "K": 48}, "cpu"),
    ("batch_matmul", {"Bsz": 2, "M": 64, "N": 128, "K": 256,
                      "dtype_bytes": 2}, "tpu"),
    ("conv2d", {"N": 1, "H": 7, "W": 8, "Cin": 64, "Cout": 32}, "tpu"),
    ("depthwise_conv2d", {"N": 2, "H": 8, "W": 16, "C": 32}, "tpu"),
    ("moe_dispatch", {"B": 1, "E": 4, "C": 64, "D": 128, "F": 256,
                      "dtype_bytes": 2}, "tpu"),
    ("ssm_scan", {"B": 1, "S": 64, "D": 32, "N": 8}, "gpu"),
    ("mlstm_chunk", {"B": 2, "H": 2, "S": 128, "R": 32, "dh": 16}, "cpu"),
]
PAIRS = [(fam, attrs, kind, t) for fam, attrs, kind in CASES
         for t in TARGET_FOR_KIND[kind]]


def _ids(case):
    fam, attrs, kind = case[:3]
    return "-".join([fam, "x".join(str(v) for v in attrs.values()), *case[2:]])


def _spaces(fam, attrs, kind):
    return (jop_registry.make_space(fam, attrs, kind),
            op_registry.make_space(fam, attrs, kind))


def _sample(space, n=6, seed=0):
    cfgs = list(space.enumerate(None))
    picks = random.Random(seed).sample(cfgs, min(n, len(cfgs)))
    return picks + [space.default_config()]


@pytest.mark.parametrize("fam,attrs,kind", CASES,
                         ids=[_ids(c) for c in CASES])
def test_space_knobs_signature_and_order(fam, attrs, kind):
    ref, port = _spaces(fam, attrs, kind)
    assert port.knobs == ref.knobs
    assert port.signature() == ref.signature()
    assert list(port.enumerate(None)) == list(ref.enumerate(None))
    assert type(port).__name__ == type(ref).__name__


@pytest.mark.parametrize("case", PAIRS, ids=[_ids(c) for c in PAIRS])
def test_visa_features_and_score_are_exact(case):
    fam, attrs, kind, tname = case
    jtarget, target = JTARGETS[tname], _port_target(JTARGETS[tname])
    ref, port = _spaces(fam, attrs, kind)
    for cfg in _sample(ref):
        jprog, jmeta = ref.instantiate(cfg)
        prog, meta = port.instantiate(cfg)
        assert visa.lower_program(prog, target).text() == \
            jvisa.lower_program(jprog, jtarget).text()
        feats = cost_model.extract_features(prog, target, meta)
        jfeats = jcost_model.extract_features(jprog, jtarget, jmeta)
        assert feats.as_dict() == jfeats.as_dict()
        assert cost_model.score(feats, target) == jcost_model.score(jfeats, jtarget)


@pytest.mark.parametrize("fam,attrs,kind,tname", [
    ("matmul", {"M": 1024, "N": 1024, "K": 1024, "dtype_bytes": 2}, "tpu", "tpu_v5e"),
    ("matmul", {"M": 256, "N": 256, "K": 256}, "cpu", "cpu_avx2"),
    ("conv2d", {"N": 1, "H": 14, "W": 14, "Cin": 256, "Cout": 256}, "cpu", "gpu_a100"),
])
def test_rank_space_and_tune_match_reference(fam, attrs, kind, tname):
    jtarget, target = JTARGETS[tname], _port_target(JTARGETS[tname])
    ref, port = _spaces(fam, attrs, kind)
    limit = min(ref.size(), 96)
    got = tuner.rank_space(port, target, limit=limit)
    want = jtuner.rank_space(ref, jtarget, limit=limit)
    assert got == want
    res = tuner.tune(port, target, seed=0)
    jres = jtuner.tune(ref, jtarget, seed=0, db=False)
    assert (res.config, res.score, res.evaluations, res.history,
            res.default_score) == (jres.config, jres.score, jres.evaluations,
                                   jres.history, jres.default_score)


def test_es_matches_reference_on_a_seeded_quadratic():
    centre = np.array([0.7, -1.3, 2.0])

    def fitness(theta):
        return -float(np.sum((theta - centre) ** 2))

    got = es.evolve(fitness, dim=3, iterations=15, population=12, seed=3)
    want = jes.evolve(fitness, dim=3, iterations=15, population=12, seed=3)
    np.testing.assert_array_equal(got.best_theta, want.best_theta)
    assert (got.best_fitness, got.evaluations, got.history) == \
        (want.best_fitness, want.evaluations, want.history)
    assert got.best_fitness > -0.5


def test_cm1_golden_feature_vector_and_score():
    """The reference's pinned cm1 golden (tests/test_tuna.py), reproduced by
    the port's copy on a TPU target built from the reference's."""
    golden = {
        "ilp_cycles": 51623.48146520146, "movement_bytes": 1572864.0,
        "unhidden_dma_cycles": 5537.469108669109, "arith_ops": 64.0,
        "ldst_ops": 0.0, "alignment_waste": 0.0, "occupancy_penalty": 0.0,
        "vmem_overflow": 0.0, "parallel_extent": 16, "dispatch_calls": 64.0,
    }
    tpu = _port_target(JTARGETS["tpu_v5e"])
    space = MatmulSpace(512, 512, 512, 2, target_kind="tpu")
    prog, meta = space.instantiate(
        {"bm": 128, "bn": 128, "bk": 128, "double_buffer": True})
    feats = cost_model.extract_features(prog, tpu, meta)
    assert cost_model.COST_MODEL_VERSION == "cm1"
    assert feats.as_dict() == pytest.approx(golden, rel=1e-9)
    assert cost_model.score(feats, tpu) == pytest.approx(6.114623058737953e-05,
                                                         rel=1e-9)


def test_port_registry_holds_the_legacy_families_only():
    """The four legacy families, then the model zoo's five in the
    reference's order (so the learned ranker's knob columns are the
    reference's), in a registry of the port's own."""
    assert op_registry.families() == LEGACY + ZOO + ("flash", "flash_gqa")
    assert op_registry.families() == jop_registry.families()
    assert op_registry._REGISTRY is not jop_registry._REGISTRY
    for name in op_registry.families():
        assert op_registry.get(name) is not jop_registry.get(name)
    space = op_registry.space_from_signature(
        "matmul[K=64,M=128,N=256,dtype_bytes=2]", "sm90")
    assert isinstance(space, MatmulSpace) and space.knobs["bn"] == [64, 128, 256]


def test_no_reference_pin_covers_the_sm90_flash_count():
    """``zoo.sm90_flash_smem_bytes`` (the Hopper flash kernel's shared
    memory, which the block picker prunes with) is the port's own: the
    reference has no ``sm90`` kind, and no case pinned against
    ``repro.core`` here runs one, so its change past 128 columns in f32
    and past 256 in 16 bits moves no pinned feature or score."""
    from repro.core import zoo as jzoo
    from repro_torch.core import zoo

    assert not hasattr(jzoo, "sm90_flash_smem_bytes")
    assert hasattr(zoo, "sm90_flash_smem_bytes")
    assert all(kind != "sm90" for _, _, kind in CASES)
    assert all(kind != "sm90" for _, _, kind, _ in PAIRS)


def test_knob_feature_union_is_the_reference_s():
    def names(reg):
        return [(kf.name, kf.kind, kf.choices, kf.feature_names())
                for kf in reg.knob_feature_union()]

    got = names(op_registry)
    assert got == names(jop_registry) and len(got) == 16
    flat = [n for *_, fn in got for n in fn]
    assert len(flat) == 18
    assert {"log2_chunk", "log2_b_d", "log2_br", "log2_bh"} <= set(flat)


@pytest.mark.parametrize("tname", ["tpu_v5e", "cpu_avx2", "gpu_a100"])
def test_reference_targets_are_copied_field_by_field(tname):
    port, ref = get_target(tname), JTARGETS[tname]
    assert type(port) is HardwareTarget and port is not ref
    for f in dataclasses.fields(ref):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "units":
            got = [(u.name, u.issue_width) for u in got]
            want = [(u.name, u.issue_width) for u in want]
        elif f.name == "instruction_table":
            got, want = dict(got), dict(want)
        assert got == want, f.name
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]


def test_target_names_and_lookup():
    assert TARGET_NAMES == ("gpu_h100", "tpu_v5e", "cpu_avx2", "gpu_a100")
    assert get_target("gpu_h100") is GPU_H100
    assert set(TARGET_NAMES) - {"gpu_h100"} == set(JTARGETS)
    with pytest.raises(KeyError, match="unknown target"):
        get_target("tpu_v4")


@pytest.mark.parametrize("fam", ZOO)
def test_zoo_families_on_sm90(fam):
    """The port's own kind: the zoo families enumerate, build and score on
    the H100 target (moe_dispatch with the Hopper matmul tiles)."""
    _, preset = next(v for v in op_registry.all_presets().values() if v[0] == fam)
    space = op_registry.make_space(fam, preset.attrs, "sm90")
    assert space.signature() == jop_registry.make_space(
        fam, preset.attrs, "tpu").signature()
    if fam == "moe_dispatch":
        assert space.knobs["bm"] == [64, 128] and space.knobs["bn"] == [64, 128, 256]
    assert space.knobs["double_buffer"] == [False, True]
    ranked = tuner.rank_space(space, GPU_H100, limit=None)
    assert len(ranked) == space.size()
    assert all(np.isfinite(s) and s > 0 for _, s in ranked)


def test_target_helpers():
    assert GPU_H100.unit_of("mxu.matmul") == "mxu"
    assert GPU_H100.latency("dma.load") == 400
    assert GPU_H100.inv_throughput("dma.load") == 10  # 128 B at 12.8 B/cycle/SM
    # one m16n8k16 per tensor core at 989 TFLOP/s over 132 SMs x 4 x 1.98 GHz
    assert GPU_H100.inv_throughput("mxu.matmul") == pytest.approx(4.33, abs=0.01)
    assert GPU_H100.bytes_per_cycle_hbm == pytest.approx(3.35e12 / 1.98e9)
    for op, (unit, _, _) in GPU_H100.instruction_table.items():
        assert unit in {u.name for u in GPU_H100.units}, op


# --------------------------------------------------------------------------
# the Hopper (sm90) matmul space and picker
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", YI6B_SHAPES + (
    (1024, 1024, 1024), (4096, 4096, 4096), (192, 4096, 320), (64, 192, 64)))
def test_sm90_space_holds_built_tiles_that_divide(shape):
    m, n, k = shape
    space = MatmulSpace(m, n, k, 2, target_kind=GPU_H100.kind)
    assert list(space.knobs) == ["bm", "bn", "bk", "double_buffer"]
    assert space.size() > 0
    for cfg in space.enumerate(None):
        for name, dim in (("bm", m), ("bn", n), ("bk", k)):
            assert cfg[name] in SM90_MATMUL_TILES[name] and dim % cfg[name] == 0


@pytest.mark.parametrize("shape", YI6B_SHAPES)
def test_tuned_matmul_blocks_fit_shared_memory_and_are_memoised(shape):
    bm, bn, bk, db = tuner.tuned_matmul_blocks(*shape)
    staged = (2 if db else 1) * (bm * bk + bk * bn) * 2
    assert staged == (2 if db else 1) * sm90_matmul_smem_bytes(bm, bn, bk, 2)
    assert staged <= 232_448 == GPU_H100.fast_mem_bytes
    before = tuner.tuned_matmul_blocks.cache_info().hits
    assert tuner.tuned_matmul_blocks(*shape) == (bm, bn, bk, db)
    assert tuner.tuned_matmul_blocks.cache_info().hits == before + 1


@pytest.mark.parametrize("shape", [(100, 4096, 4096), (2048, 4096, 48),
                                   (16, 64, 64), (2048, 80, 4096),
                                   (96, 4096, 160), (64, 96, 32)])
def test_tuned_matmul_blocks_refuses_shapes_no_built_tile_divides(shape):
    """It refused these shapes while the kernel's tiles had to divide the
    shape. Now each dimension that no built tile divides takes the built
    tiles up to the first that covers it, run with a ragged last tile, so
    every shape gets a pick, and the pick is one of them."""
    m, n, k = shape
    pick = tuner.tuned_matmul_blocks(*shape)
    for name, dim, tile in (("bm", m, pick[0]), ("bn", n, pick[1]), ("bk", k, pick[2])):
        built = SM90_MATMUL_TILES[name]
        divisors = [t for t in built if dim % t == 0]
        covers = [t for t in built if t >= dim]
        allowed = divisors or [t for t in built if not covers or t <= covers[0]]
        assert tile in allowed, (name, dim, tile)


@pytest.mark.parametrize("bm,bn,bk", list(itertools.product(*SM90_MATMUL_TILES.values())))
def test_sm90_smem_accounting_leaves_out_the_c_tile(bm, bn, bk):
    """One stage holds an A tile and a B tile, unpadded; the C tile stays in
    the kernel's registers, so the model neither counts it nor calls two
    stages of any built tile an overflow."""
    assert sm90_matmul_smem_bytes(bm, bn, bk, 2) == (bm * bk + bk * bn) * 2
    assert 2 * sm90_matmul_smem_bytes(bm, bn, bk, 2) <= GPU_H100.fast_mem_bytes
    space = MatmulSpace(bm, bn, bk, 2, target_kind=GPU_H100.kind)
    for db in (False, True):
        prog, meta = space.instantiate({"bm": bm, "bn": bn, "bk": bk, "double_buffer": db})
        assert meta.vmem_tile_bytes == sm90_matmul_smem_bytes(bm, bn, bk, 2)
        feats = cost_model.extract_features(prog, GPU_H100, meta)
        assert feats.vmem_overflow == 0.0


@pytest.mark.parametrize("shape", [(2048, 11008, 4096), (2048, 4096, 11008),
                                   (2048, 64000, 4096), (2048, 4096, 4096)])
def test_static_pick_takes_two_stages_at_bk_128(shape):
    """Where two bk=128 stages fit, the model prefers them to the one-stage
    twin (the card's order in every earlier chip run); with the C tile
    counted as staged it used to pick the twin at the first three shapes."""
    bm, bn, bk, db = tuner.tuned_matmul_blocks(*shape)
    assert (bk, db) == (128, True)
    assert 2 * sm90_matmul_smem_bytes(bm, bn, bk, 2) <= GPU_H100.fast_mem_bytes


@pytest.mark.parametrize("m,n,k", [(512, 512, 512), (256, 384, 128), (1024, 2048, 4096)])
def test_tpu_tile_bytes_and_scores_match_the_reference(m, n, k):
    """The sm90 accounting leaves the ``tpu`` kind as the reference has it:
    every configuration's ScheduleMeta (C tile counted) and score agree
    with ``repro.core``'s on the reference's TPU target."""
    attrs = {"M": m, "N": n, "K": k, "dtype_bytes": 2}
    ref, port = _spaces("matmul", attrs, "tpu")
    jtarget, target = JTARGETS["tpu_v5e"], _port_target(JTARGETS["tpu_v5e"])
    cfgs = list(ref.enumerate(None))
    assert cfgs == list(port.enumerate(None))
    for cfg in cfgs:
        jprog, jmeta = ref.instantiate(cfg)
        prog, meta = port.instantiate(cfg)
        assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
        assert meta.vmem_tile_bytes == (cfg["bm"] * cfg["bk"] + cfg["bk"] * cfg["bn"]
                                        + cfg["bm"] * cfg["bn"]) * 2
        assert cost_model.evaluate(prog, target, meta) == \
            jcost_model.evaluate(jprog, jtarget, jmeta)


def test_sm90_matmul_is_tensorized():
    """The best score at (2048, 4096, 4096) lies between the data-sheet
    bound (2*M*N*K / 989 TFLOP/s = 0.0695 ms) and 10x of it: the model sees
    the tensor cores, where the reference's SIMT GPU model (``gpu_a100``,
    kind "gpu") scores a (128, 128, 64) schedule of the same product above
    0.4 s. Its VISA has mma tiles and no SIMT FMA."""
    m, n, k = 2048, 4096, 4096
    bound = 2 * m * n * k / GPU_H100.peak_flops_bf16
    space = MatmulSpace(m, n, k, 2, target_kind=GPU_H100.kind)
    cfg, best = tuner.best_schedule(space, GPU_H100)
    assert bound < best < 10 * bound
    simt = MatmulSpace(m, n, k, 2, target_kind="gpu")
    simt_cfg = {"bm": 128, "bn": 128, "bk": 64, "order": "ikj", "unroll_i": 1}
    simt_score = tuner._score_config(simt, _port_target(JTARGETS["gpu_a100"]), simt_cfg)
    assert simt_score == jtuner._score_config(
        jop_registry.make_space("matmul", {"M": m, "N": n, "K": k,
                                           "dtype_bytes": 2}, "gpu"),
        JTARGETS["gpu_a100"], simt_cfg)
    assert simt_score > 0.4
    prog, _ = space.instantiate(cfg)
    text = visa.lower_program(prog, GPU_H100).text()
    assert "simd." not in text
    tiles = (cfg["bm"] // 16) * (cfg["bn"] // 8) * (cfg["bk"] // 16)
    assert text.count("mxu.matmul") == tiles


def test_gpu_kinds_stay_apart():
    """``sm90`` gets the block-tile knobs; ``gpu`` (the reference's SIMT
    model) keeps the CPU knobs, exactly as in the reference."""
    sm90 = MatmulSpace(256, 256, 256, 2, target_kind="sm90")
    gpu = MatmulSpace(256, 256, 256, 2, target_kind="gpu")
    jgpu = jop_registry.make_space("matmul", {"M": 256, "N": 256, "K": 256,
                                              "dtype_bytes": 2}, "gpu")
    assert "double_buffer" in sm90.knobs and "order" not in sm90.knobs
    assert gpu.knobs == jgpu.knobs and "order" in gpu.knobs


def test_topk_ratio_plumbing_on_the_cpu():
    """The top-k benchmark on the plain version at a small shape: every
    config of the space measured once, the ranking in static order, the
    reference's keys. (A CPU time says nothing about the card.)"""
    res = topk_ratio.topk_ratio_matmul(128, 128, 128, ks=(1, 5), iters=1,
                                       device="cpu")
    space = MatmulSpace(128, 128, 128, 2, target_kind="sm90")
    assert res["n_configs"] == res["space_size"] == space.size()
    for key in ("ratio@1", "ratio@5", "top1_ratio", "best_static_ms",
                "best_oracle_ms", "static_s", "measure_s"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    assert res["ratio@1"] == res["top1_ratio"] <= 1.0
    scores = [r["score"] for r in res["ranking"]]
    assert scores == sorted(scores)
    assert res["ranking"][0]["config"] == dict(zip(
        ("bm", "bn", "bk", "double_buffer"),
        tuner.tuned_matmul_blocks(128, 128, 128)))


def test_topk_ratio_command_line_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "topk.json"
    assert topk_ratio.main(["--device", "cpu", "--shape", "64", "64", "64",
                            "--iters", "1", "--out", str(out)]) == 0
    assert "64x64x64 on cpu: ratio@1=" in capsys.readouterr().out
    res = json.loads(out.read_text())
    assert res["device"] == "cpu"
    assert -1.0 <= res["results"]["64x64x64"]["rank_corr"] <= 1.0


def test_topk_ratio_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topk_ratio.main(["--shape", "64", "128", "64"])
