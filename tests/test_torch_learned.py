"""The rest of the port's static tuner held against the reference: the
calibration (``repro_torch.core.calibrate``), the learned ranker
(``repro_torch.core.learned``, ``repro_torch.tuna.learned``), the tuner's
calibrated and hybrid tiers, the CLI's ``train``/``eval`` and the top-k
benchmark's calibrated, store and hybrid options.

Parity first: ``FEATURE_NAMES`` equal in order, then feature rows compared
by name, then datasets (rtol 1e-12), fingerprints, versions and artifacts
that load in either package. Then the port's copies of the reference's
``tests/test_learned.py``, ``TestCalibration`` and ``TestOperatorSpaces`` of
``tests/test_tuna_extra.py``, and ``TestSmokeTuneAllTargets`` and
``TestLearnedFeatureLayout`` of ``tests/test_op_registry.py``, as far as
they apply (the controller's retrain cell among them). Everything runs on the CPU,
where a measured time is the plain version's and says nothing of the card.
"""
import json
import math
import os
import re
import shutil

import numpy as np
import pytest
import torch

import benchmarks.measure as jmeasure
import test_distribution as jdist
from repro.core import calibrate as jcalibrate
from repro.core import cost_model as jcost_model
from repro.core import learned as jlearned
from repro.core import op_registry as jop_registry
from repro.core import tuner as jtuner
from repro.hw import get_target as jget_target
from repro.tuna import cli as jcli
from repro.tuna import learned as jtlearned
from repro.tuna.db import ScheduleDatabase as JScheduleDatabase
from repro_torch.benchmarks import measure, topk_ratio
from repro_torch.configs.tuna_ops import OPERATORS, ZOO_OPERATORS
from repro_torch.core import calibrate, cost_model, op_registry, tuner
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.core.learned import (
    FEATURE_NAMES,
    LearnedRanker,
    featurize,
    fit_ranker,
    hlo_counts,
    load_ranker,
    measured_version,
    save_ranker,
    space_from_signature,
    spearman,
)
from repro_torch.core.spaces import MatmulSpace, Space
from repro_torch.hw import get_target
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.tuna import cli
from repro_torch.tuna.cache import StaleSnapshotError, StaleSnapshotWarning
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord
from repro_torch.tuna.learned import (
    LearnedManager,
    build_dataset,
    iter_log_records,
    train_from_store,
    training_rows,
    training_sha1,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DB = os.path.join(ROOT, "experiments", "schedule_db.jsonl")
REF_CAL = os.path.join(ROOT, "experiments", "cpu_calibration.json")
CPU = get_target("cpu_avx2")
TPU = get_target("tpu_v5e")
KIND_TARGET = {"tpu": "tpu_v5e", "cpu": "cpu_avx2", "gpu": "gpu_a100",
               "sm90": "gpu_h100"}


@pytest.fixture(autouse=True)
def _port_defaults_off(monkeypatch, tmp_path):
    """The port's process defaults off around every test, whatever the
    environment says, and fits cached under the test's own directory."""
    for var in ("REPRO_TUNA_DB", "REPRO_TUNA_CACHE", "REPRO_TUNA_BUNDLE",
                "REPRO_TUNA_LEARNED"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(calibrate, "CALIBRATION_DIR", tmp_path / "calibration")

    def off():
        tuner.set_default_db(None)
        tuner.set_default_cache(None)
        tuner.set_default_bundle(None)
        tuner.set_default_learned(None)

    off()
    yield
    off()


def _space() -> MatmulSpace:
    return MatmulSpace(64, 64, 64, 4, target_kind="cpu")


def _fit_synthetic(space=None, target=CPU, n=80, seed=0):
    """A ranker fitted on scores that are exactly log-linear in the
    feature vector: the fit must recover the ordering."""
    space = space or _space()
    cfgs = list(space.enumerate(space.size()))[:n]
    X = np.stack([featurize(space, target, c) for c in cfgs])
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(X.shape[1])
    y = np.exp((X - X.mean(0)) / (X.std(0) + 1e-9) @ w * 0.1)
    model = fit_ranker(X, y, ["cm1-meas"] * len(y))
    return model, space, cfgs, X, y


def _seed_store(path, spaces=(("cpu", 64), ("cpu", 128)), per_space=24,
                version=None, db_cls=ScheduleDatabase, rec_cls=ScheduleRecord):
    """A store whose log carries measured-lineage samples (score = static
    cm1 score times a deterministic perturbation) for a couple of spaces."""
    db = db_cls(path)
    version = version or measured_version()
    rng = np.random.default_rng(0)
    for kind, n in spaces:
        space = MatmulSpace(n, n, n, 4, target_kind=kind)
        target = CPU if kind == "cpu" else TPU
        cfgs = list(space.enumerate(space.size()))[:per_space]
        for cfg in cfgs:
            s = tuner._score_config(space, target, cfg)
            db.add(rec_cls(
                op=space.signature(), target=target.name, config=cfg,
                score=float(s * rng.uniform(0.8, 1.25)), evaluations=1,
                meta={"strategy": "measured_sample"}, version=version))
    return db


def _copy(src, tmp_path, name=None):
    dst = tmp_path / (name or os.path.basename(src))
    shutil.copyfile(src, dst)
    return str(dst)


# --------------------------------------------------------------------------
# layout and feature parity
# --------------------------------------------------------------------------


def test_feature_names_equal_the_reference_s_in_order():
    assert FEATURE_NAMES == jlearned.FEATURE_NAMES
    assert len(FEATURE_NAMES) == 32
    assert [kf.name for kf in jlearned.KNOB_FEATURES] == \
        [kf.name for kf in op_registry.knob_feature_union()]


FEATURE_CASES = [(name, kind) for name in sorted(OPERATORS)
                 for kind in ("tpu", "cpu", "gpu")]


@pytest.mark.parametrize("name,kind", FEATURE_CASES,
                         ids=[f"{n}-{k}" for n, k in FEATURE_CASES])
def test_featurize_rows_equal_the_reference_s_by_name(name, kind):
    """Every preset on every kind of the reference: a few configs, each
    row compared column by column, by name."""
    from repro.configs.tuna_ops import OPERATORS as JOPERATORS

    space, jspace = OPERATORS[name](kind), JOPERATORS[name](kind)
    target, jtarget = get_target(KIND_TARGET[kind]), jget_target(KIND_TARGET[kind])
    cfgs = list(space.enumerate(None))
    cfgs = [cfgs[i] for i in sorted({0, len(cfgs) // 2, len(cfgs) - 1})]
    for cfg in cfgs:
        got = dict(zip(FEATURE_NAMES, featurize(space, target, cfg)))
        want = dict(zip(jlearned.FEATURE_NAMES, jlearned.featurize(jspace, jtarget, cfg)))
        assert got == want, cfg


def test_hlo_counts_zero_without_text_and_refused_with_it():
    """No text: zeros. With HLO text (the reference's parsing cell, a module
    of fusions and dots, a while loop) the counts equal
    ``repro.core.learned.hlo_counts`` of the same text (the port's own
    ``core/hlo_features`` parser; it raised before the parser was
    ported)."""
    assert hlo_counts(None) == hlo_counts("") == (0.0,) * 4
    fused = ("HloModule m\n%f = f32[8,8]{1,0} fusion(%a), kind=kLoop\n"
             "%d = f32[8,8]{1,0} dot(%a, %b)\n%t = f32[8,8]{0,1} transpose(%d)\n"
             "%c = f32[8,8]{1,0} copy(%t)\n%w = (s32[]) while(%i), condition=%c1, body=%b1\n")
    for text in (jdist.TestHloParsing.HLO, fused,
                 "HloModule m\nENTRY e { ROOT c = f32[] constant(0) }"):
        assert hlo_counts(text) == jlearned.hlo_counts(text), text
    assert hlo_counts(fused) == (1.0, 1.0, 2.0, 1.0)


# --------------------------------------------------------------------------
# calibration against the reference
# --------------------------------------------------------------------------


def test_nnls_equals_the_reference_s():
    rng = np.random.default_rng(3)
    A = np.abs(rng.standard_normal((30, 6)))
    y = A @ np.array([0.4, 0.0, 1.5, 0.2, 0.0, 0.7]) + 0.01 * rng.standard_normal(30)
    np.testing.assert_array_equal(calibrate._nnls(A, y), jcalibrate._nnls(A, y))


def _probe_seconds(cfg):
    """One deterministic function of a cpu-kind config's static features
    (the reference's, at the 256^3 probe): the stand-in measurement."""
    space = jop_registry.make_space(
        "matmul", {"M": 256, "N": 256, "K": 256, "dtype_bytes": 4}, "cpu")
    prog, meta = space.instantiate(cfg)
    f = jcost_model.extract_features(prog, jget_target("cpu_avx2"), meta)
    return (3e-10 * f.ilp_cycles + 2e-12 * f.movement_bytes
            + 4e-6 * f.dispatch_calls + 1e-4 * (1 + cfg["unroll_i"] % 2))


def test_fit_cpu_coefficients_equals_the_reference_s(monkeypatch):
    monkeypatch.setattr(jmeasure, "measure_config",
                        lambda M, N, K, cfg, a, b, iters=5: _probe_seconds(cfg))
    monkeypatch.setattr(measure, "measure_config",
                        lambda a, b, cfg, warmup=3, iters=10: _probe_seconds(cfg))
    want = jcalibrate.fit_cpu_coefficients()
    got = calibrate.fit_cpu_coefficients()
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-9, abs=1e-300), key
    assert got["_r2_on_probe"] > 0.9
    assert (got["_target"], got["_probe"], got["_n_configs"], got["_seed"]) == \
        ("cpu_avx2", [256, 256, 256], 16, 123)


def test_scoring_coefficients_and_version_of_the_reference_fit(tmp_path):
    path = _copy(REF_CAL, tmp_path)
    with open(path) as f:
        fitted = json.load(f)
    got = calibrate.coeffs_for_scoring(fitted)
    assert got == jcalibrate.coeffs_for_scoring(fitted)
    assert tuner.record_version(got) == jtuner.record_version(got)
    assert re.fullmatch(r"cm1-cal-[0-9a-f]{8}", tuner.record_version(got))
    assert tuner.record_version(None) == jtuner.record_version(None) == "cm1"


def test_calibrated_scores_equal_the_reference_s(tmp_path):
    with open(_copy(REF_CAL, tmp_path)) as f:
        coeffs = calibrate.coeffs_for_scoring(json.load(f))
    space, jspace = MatmulSpace(128, 128, 128, 4, "cpu"), jop_registry.make_space(
        "matmul", {"M": 128, "N": 128, "K": 128, "dtype_bytes": 4}, "cpu")
    got = tuner.rank_space(space, CPU, limit=64, coeffs=coeffs)
    assert got == jtuner.rank_space(jspace, jget_target("cpu_avx2"), limit=64,
                                    coeffs=coeffs)


def test_gpu_probe_is_apart_from_the_scored_shapes():
    (m, n, k), dtype_bytes, measured_on = calibrate.PROBES["gpu_h100"]
    assert (m, n, k) not in topk_ratio.YI6B_SHAPES
    assert (dtype_bytes, measured_on) == (2, "cuda")
    space = MatmulSpace(m, n, k, 2, target_kind="sm90")
    assert space.size() == 24  # every built tile divides the probe
    assert calibrate.PROBES["cpu_avx2"] == ((256, 256, 256), 4, "cpu")


def test_gpu_fit_plumbing_on_the_cpu_collects_and_caches(tmp_path):
    """The gpu_h100 fit measured through the plain version at a small
    probe: finite non-negative coefficients, every probe time kept as a
    cm1-meas record, cached under the target and the card's name."""
    store = str(tmp_path / "db.jsonl")
    fit = calibrate.cached_coeffs("gpu_h100", "cpu", probe=(128, 128, 128),
                                  iters=1, db=store)
    coef = [fit[k] for k in calibrate.FEATURES + ("intercept",)]
    assert all(math.isfinite(v) and v >= 0 for v in coef)
    assert fit["_card"] == calibrate.card_name("cpu")
    assert fit["_n_configs"] == 16 and fit["_probe"] == [128, 128, 128]
    path = calibrate.cache_path("gpu_h100", "cpu")
    assert path.parent == calibrate.CALIBRATION_DIR
    assert path.name.startswith("gpu_h100.cpu-")
    with open(path) as f:
        assert json.load(f) == fit
    rows = list(iter_log_records(store))
    assert len(rows) == 16 and {r.version for r in rows} == {measured_version()}
    assert {r.target for r in rows} == {"gpu_h100"}
    # cached: a second call measures nothing
    assert calibrate.cached_coeffs("gpu_h100", "cpu") == fit


def test_a_failed_fit_raises_and_caches_nothing(monkeypatch):
    """Unlike the reference's cached_cpu_coeffs, nothing is swallowed."""
    def boom(*a, **kw):
        raise RuntimeError("measurement failed")

    monkeypatch.setattr(measure, "measure_config", boom)
    with pytest.raises(RuntimeError, match="measurement failed"):
        calibrate.cached_coeffs("cpu_avx2", "cpu")
    assert not calibrate.cache_path("cpu_avx2", "cpu").exists()
    with pytest.raises(KeyError, match="no calibration probe"):
        calibrate.fit_coefficients("tpu_v5e", "cpu")


def test_calibration_defaults_to_the_card_for_gpu_h100():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.cached_coeffs("gpu_h100")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topk_ratio.topk_ratio_matmul(64, 64, 64, calibrated=True)


def test_cpu_kind_measurement_runs_the_k_slices():
    a = torch.randn(64, 96)
    b = torch.randn(96, 32)
    from repro_torch.kernels.matmul import k_slices

    torch.testing.assert_close(k_slices(a, b, 32), a @ b, rtol=1e-5, atol=1e-5)
    cfg = {"bm": 4, "bn": 8, "bk": 32, "order": "kij", "unroll_i": 2}
    assert measure.measure_config(a, b, cfg, warmup=1, iters=1) > 0


# --------------------------------------------------------------------------
# the learned ranker against the reference
# --------------------------------------------------------------------------


def test_dataset_fingerprint_and_version_equal_the_reference_s(tmp_path):
    path = _copy(REF_DB, tmp_path)
    rows, jrows = (training_rows(iter_log_records(path)),
                   jtlearned.training_rows(jtlearned.iter_log_records(path)))
    assert training_sha1(rows) == jtlearned.training_sha1(jrows)
    X, y, groups, skipped = build_dataset(rows)
    jX, jy, jgroups, jskipped = jtlearned.build_dataset(jrows)
    assert (groups, skipped) == (jgroups, jskipped) and len(y) > 0
    np.testing.assert_allclose(X, jX, rtol=1e-12, atol=0)
    np.testing.assert_allclose(y, jy, rtol=1e-12, atol=0)
    model, tsha, n, sk = train_from_store(path)
    jmodel, jtsha, jn, jsk = jtlearned.train_from_store(path)
    assert model.fingerprint() == jmodel.fingerprint()
    assert model.version == jmodel.version
    assert (tsha, n, sk, model.lineages) == (jtsha, jn, jsk, jmodel.lineages)


def test_augmented_dataset_equals_the_reference_s(tmp_path):
    path = str(tmp_path / "db.jsonl")
    _seed_store(path, per_space=6)
    rows = training_rows(iter_log_records(path))
    jrows = jtlearned.training_rows(jtlearned.iter_log_records(path))
    X, y, groups, _ = build_dataset(rows, augment=5, seed=1)
    jX, jy, jgroups, _ = jtlearned.build_dataset(jrows, augment=5, seed=1)
    assert groups == jgroups
    np.testing.assert_allclose(X, jX, rtol=1e-12, atol=0)
    np.testing.assert_allclose(y, jy, rtol=1e-12, atol=0)


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_artifacts_load_in_either_package(saved_by, tmp_path):
    path = _copy(REF_DB, tmp_path)
    model = (train_from_store if saved_by == "port" else jtlearned.train_from_store)(path)[0]
    art = str(tmp_path / "m.json")
    (save_ranker if saved_by == "port" else jlearned.save_ranker)(model, art)
    port, ref = load_ranker(art), jlearned.load_ranker(art)
    assert port.fingerprint() == ref.fingerprint() == model.fingerprint()
    assert port.version == ref.version
    X, *_ = build_dataset(training_rows(iter_log_records(path)))
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def _tamper(path, fix_sha):
    import hashlib

    with open(path) as f:
        obj = json.load(f)
    obj["model"]["weights"][0] += 1.0
    if fix_sha:
        blob = json.dumps(obj["model"], sort_keys=True, default=float)
        obj["sha1"] = hashlib.sha1(blob.encode()).hexdigest()
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.mark.parametrize("how,err", [("digest", "digest mismatch"),
                                     ("fingerprint", "fingerprint mismatch")])
def test_tampered_artifacts_raise_as_in_the_reference(how, err, tmp_path):
    model, *_ = _fit_synthetic()
    art = str(tmp_path / "m.json")
    jlearned.save_ranker(model, art)
    _tamper(art, fix_sha=how == "fingerprint")
    for load in (load_ranker, jlearned.load_ranker):
        with pytest.raises(ValueError, match=err):
            load(art)


def test_stale_artifacts_raise_as_in_the_reference(tmp_path):
    from repro.tuna.cache import StaleSnapshotError as JStale

    model, *_ = _fit_synthetic()
    model.cost_model_version = "cm0"
    art = str(tmp_path / "m.json")
    save_ranker(model, art)
    with pytest.raises(StaleSnapshotError, match="cm0"):
        load_ranker(art)
    with pytest.raises(JStale, match="cm0"):
        jlearned.load_ranker(art)


def test_rerank_rank_space_and_best_schedule_match_the_reference(tmp_path):
    """One artifact served by both tuners on the same cpu space: the same
    hybrid order, the same record written under the same +lr version."""
    store = str(tmp_path / "train.jsonl")
    _seed_store(store, per_space=32)
    model = train_from_store(store)[0]
    art = str(tmp_path / "m.json")
    save_ranker(model, art)
    jmodel = jlearned.load_ranker(art)
    space, jspace = MatmulSpace(128, 128, 128, 4, "cpu"), jop_registry.make_space(
        "matmul", {"M": 128, "N": 128, "K": 128, "dtype_bytes": 4}, "cpu")
    jcpu = jget_target("cpu_avx2")
    static = tuner.rank_space(space, CPU, limit=96)
    assert model.rerank(space, CPU, static, top=32) == \
        jmodel.rerank(jspace, jcpu, static, top=32)
    db, jdb = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    got = tuner.rank_space(space, CPU, limit=96, db=db, learned=art)
    want = jtuner.rank_space(jspace, jcpu, limit=96, db=jdb, learned=jmodel)
    assert got == want and got != static
    hv = model.hybrid_version(COST_MODEL_VERSION)
    rec = ScheduleDatabase(db).best(space.signature(), CPU.name, version=hv)
    jrec = JScheduleDatabase(jdb).best(jspace.signature(), jcpu.name, version=hv)
    assert rec.config == jrec.config and rec.score == jrec.score
    assert rec.meta["strategy"] == jrec.meta["strategy"] == "hybrid"
    # best_schedule on a fresh store: the same pick, written under the same version
    fresh, jfresh = str(tmp_path / "p2.jsonl"), str(tmp_path / "j2.jsonl")
    assert tuner.best_schedule(space, CPU, db=fresh, learned=model) == \
        jtuner.best_schedule(jspace, jcpu, db=jfresh, learned=jmodel)
    assert [(r.version, r.config) for r in ScheduleDatabase(fresh).records()] == \
        [(r.version, r.config) for r in JScheduleDatabase(jfresh).records()]


def test_spearman_equals_the_reference_s():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(40), rng.standard_normal(40)
    assert spearman(a, b) == jlearned.spearman(a, b)
    assert spearman(a, a) == pytest.approx(1.0)


# --------------------------------------------------------------------------
# the port's copy of tests/test_learned.py
# --------------------------------------------------------------------------


class TestFeaturesAndFit:
    def test_featurize_finite_and_deterministic(self):
        space = _space()
        cfg = space.default_config()
        v1 = featurize(space, CPU, cfg)
        v2 = featurize(space, CPU, cfg)
        assert v1.shape == (len(FEATURE_NAMES),)
        assert np.all(np.isfinite(v1)) and np.array_equal(v1, v2)
        other = dict(cfg)
        other["bm"] = [b for b in space.knobs["bm"] if b != cfg["bm"]][0]
        assert not np.array_equal(v1, featurize(space, CPU, other))

    def test_fit_recovers_synthetic_ranking(self):
        model, space, cfgs, X, y = _fit_synthetic()
        assert spearman(model.predict(X), np.log(y)) > 0.95

    def test_per_lineage_standardisation_isolates_scales(self):
        space = _space()
        cfgs = list(space.enumerate(space.size()))[:60]
        X = np.stack([featurize(space, CPU, c) for c in cfgs])
        w = np.linspace(-1, 1, X.shape[1])
        base = np.exp((X - X.mean(0)) / (X.std(0) + 1e-9) @ w * 0.1)
        model = fit_ranker(np.concatenate([X, X]),
                           np.concatenate([base, base * 1e6]),
                           ["cm1"] * len(base) + ["cm1-meas"] * len(base))
        assert spearman(model.predict(X), np.log(base)) > 0.95
        assert model.lineages == {"cm1": 60, "cm1-meas": 60}

    def test_rerank_orders_head_only(self):
        model, space, cfgs, X, y = _fit_synthetic()
        static = sorted([(c, float(s)) for c, s in zip(cfgs, y)], key=lambda cs: cs[1])
        out = model.rerank(space, CPU, static, top=10)
        assert len(out) == len(static) and out[10:] == static[10:]
        assert sorted(map(str, out[:10])) == sorted(map(str, static[:10]))
        preds = model.predict(np.stack([featurize(space, CPU, c) for c, _ in out[:10]]))
        assert list(preds) == sorted(preds)

    @pytest.mark.parametrize("kind", ["cpu", "sm90"])
    def test_space_from_signature_roundtrip(self, kind):
        target = get_target(KIND_TARGET[kind])
        for name, make in OPERATORS.items():
            space = make(kind)
            back = space_from_signature(space.signature(), target)
            assert back is not None, name
            assert back.signature() == space.signature()
            assert back.knobs == space.knobs
        assert space_from_signature("cell[L=4]", CPU) is None

    def test_align_reads_an_older_layout_by_name(self):
        model, space, cfgs, X, y = _fit_synthetic()
        keep = [i for i, n in enumerate(FEATURE_NAMES) if "log2_chunk" not in n]
        old = LearnedRanker(weights=model.weights[keep], bias=model.bias,
                            mean=model.mean[keep], std=model.std[keep],
                            feature_names=tuple(FEATURE_NAMES[i] for i in keep))
        np.testing.assert_allclose(old.predict(X), old.predict(X[:, keep]))


class TestArtifact:
    def test_save_load_roundtrip_and_version_tag(self, tmp_path):
        model, space, cfgs, X, y = _fit_synthetic()
        path = str(tmp_path / "m.json")
        save_ranker(model, path)
        back = load_ranker(path)
        assert re.fullmatch(rf"{COST_MODEL_VERSION}\+lr[0-9a-f]{{8}}", back.version)
        assert back.version == model.version
        assert back.hybrid_version("cm1-cal-abc12345") == \
            f"cm1-cal-abc12345+lr{model.fingerprint()[:8]}"
        assert np.allclose(back.predict(X), model.predict(X))
        assert back.lineages == model.lineages

    def test_stale_cost_model_version_rejected_by_the_tuner(self, tmp_path):
        model, *_ = _fit_synthetic()
        model.cost_model_version = "cm0"
        path = str(tmp_path / "m.json")
        save_ranker(model, path)
        with pytest.raises(StaleSnapshotError):
            tuner.set_default_learned(path)

    def test_env_learned_missing_resolves_off(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TUNA_LEARNED", str(tmp_path / "never_trained.json"))
        monkeypatch.setattr(tuner, "_DEFAULT_LEARNED", tuner._UNSET)
        assert tuner.get_default_learned() is None

    def test_env_learned_loads_and_installs(self, tmp_path, monkeypatch):
        model, *_ = _fit_synthetic()
        path = str(tmp_path / "m.json")
        save_ranker(model, path)
        monkeypatch.setenv("REPRO_TUNA_LEARNED", path)
        monkeypatch.setattr(tuner, "_DEFAULT_LEARNED", tuner._UNSET)
        assert tuner.get_default_learned().fingerprint() == model.fingerprint()
        assert tuner.resolve_learned(False) is None
        assert tuner.resolve_learned(model) is model

    def test_env_learned_stale_warns_off_and_clears_memos(self, tmp_path, monkeypatch):
        model, *_ = _fit_synthetic()
        model.cost_model_version = "cm0"
        stale = str(tmp_path / "stale.json")
        save_ranker(model, stale)
        cleared = []
        tuner.register_memo_clearer(lambda: cleared.append(1))
        try:
            monkeypatch.setenv("REPRO_TUNA_LEARNED", stale)
            monkeypatch.setattr(tuner, "_DEFAULT_LEARNED", tuner._UNSET)
            with pytest.warns(StaleSnapshotWarning, match="REPRO_TUNA_LEARNED disabled"):
                assert tuner.get_default_learned() is None
            assert cleared
        finally:
            tuner._MEMO_CLEARERS.pop()


class TestHybridServe:
    def test_miss_writes_hybrid_version_then_warm_hits(self, tmp_path, monkeypatch):
        model, space, *_ = _fit_synthetic()
        path = str(tmp_path / "db.jsonl")
        tuner.set_default_learned(model)
        cfg, score = tuner.best_schedule(space, CPU, db=path)
        db = ScheduleDatabase(path)
        hv = model.hybrid_version(COST_MODEL_VERSION)
        rec = db.best(space.signature(), CPU.name, version=hv)
        assert rec is not None and rec.meta["strategy"] == "hybrid"
        assert rec.config == cfg
        assert db.best(space.signature(), CPU.name) is None

        def boom(*a, **kw):
            raise AssertionError("searched despite hybrid warm record")

        monkeypatch.setattr(cost_model, "evaluate", boom)
        assert tuner.best_schedule(_space(), CPU, db=path) == (cfg, score)

    def test_hybrid_falls_back_to_plain_static_records(self, tmp_path, monkeypatch):
        space = _space()
        path = str(tmp_path / "db.jsonl")
        ranked = tuner.rank_space(space, CPU, limit=space.size(), db=path)
        model, *_ = _fit_synthetic()
        tuner.set_default_learned(model)

        def boom(*a, **kw):
            raise AssertionError("searched despite plain cm1 warm record")

        monkeypatch.setattr(cost_model, "evaluate", boom)
        assert tuner.best_schedule(_space(), CPU, db=path) == ranked[0]

    def test_calibrated_version_warm_hit(self, tmp_path, monkeypatch):
        space = _space()
        path = str(tmp_path / "db.jsonl")
        coeffs = dict(cost_model.coefficients(CPU), ilp_cycles=2.0)
        ranked = tuner.rank_space(space, CPU, limit=space.size(), coeffs=coeffs, db=path)
        version = tuner.record_version(coeffs)
        assert version.startswith(f"{COST_MODEL_VERSION}-cal-")

        def boom(*a, **kw):
            raise AssertionError("searched despite calibrated warm record")

        monkeypatch.setattr(cost_model, "evaluate", boom)
        assert tuner.best_schedule(_space(), CPU, coeffs=coeffs, db=path) == ranked[0]
        assert tuner.best_schedule(_space(), CPU, version=version, db=path) == ranked[0]

    def test_the_matmul_block_pick_follows_an_installed_ranker(self, tmp_path):
        """The Hopper block picker reads the hybrid lineage too: with a
        ranker installed its record lands under <cm1>+lr<fp>."""
        model, *_ = _fit_synthetic(MatmulSpace(256, 256, 256, 2, "sm90"), GPU_H100, n=24)
        path = str(tmp_path / "db.jsonl")
        tuner.set_default_db(path)
        tuner.set_default_learned(model)
        tuner.tuned_matmul_blocks(256, 256, 256)
        sig = MatmulSpace(256, 256, 256, 2, "sm90").signature()
        rec = ScheduleDatabase(path).best(sig, GPU_H100.name,
                                          version=model.hybrid_version())
        assert rec is not None and rec.meta["rerank_top"] == 32


class TestSampleSpaceLimit:
    class BigSpace(Space):
        name = "bigspace"

        def __init__(self):
            super().__init__()
            self.knobs = {"a": list(range(16)), "b": list(range(16)),
                          "c": list(range(16)), "d": [0, 1]}

    def test_full_space_by_default(self):
        space = self.BigSpace()
        assert space.size() == 8192
        assert len(topk_ratio.sample_space(space, space.size())) == 8192

    def test_explicit_limit_is_loud(self, capsys):
        got = topk_ratio.sample_space(self.BigSpace(), 10, seed=3, limit=100)
        assert len(got) == 10
        assert "truncated to 100 of 8192" in capsys.readouterr().err
        topk_ratio.sample_space(self.BigSpace(), 10, seed=3, limit=10_000)
        assert "truncated" not in capsys.readouterr().err

    @pytest.mark.parametrize("n,seed,limit", [(10, 3, 100), (16, 123, None),
                                              (5, 0, 40), (2000, 1, None)])
    def test_picks_equal_the_reference_s(self, n, seed, limit):
        from benchmarks.topk_ratio import sample_space as jsample_space

        attrs = {"M": 256, "N": 256, "K": 256, "dtype_bytes": 4}
        space = op_registry.make_space("matmul", attrs, "cpu")
        jspace = jop_registry.make_space("matmul", attrs, "cpu")
        assert topk_ratio.sample_space(space, n, seed, limit=limit) == \
            jsample_space(jspace, n, seed, limit=limit)


class TestTrainingAndLifecycle:
    def test_log_not_index_is_the_training_set(self, tmp_path):
        path = str(tmp_path / "db.jsonl")
        db = _seed_store(path)
        assert len(db) == 2
        assert len(training_rows(iter_log_records(path))) == 48

    def test_training_rows_exclude_hybrid_and_foreign(self):
        mk = lambda v: ScheduleRecord(op="matmul[K=64,M=64,N=64,dtype_bytes=4]",
                                      target="cpu_avx2", config={}, score=1.0, version=v)
        rows = training_rows([mk("cm1"), mk("cm1-cal-deadbeef"), mk("cm1-meas"),
                              mk("cm1-cal-ab+lr12345678"), mk("cm1+lr12345678"),
                              mk("cm0")])
        assert [r.version for r in rows] == ["cm1", "cm1-cal-deadbeef", "cm1-meas"]

    def test_training_sha1_ignores_order_and_bookkeeping(self):
        a = ScheduleRecord(op="x[]", target="t", config={"bm": 4}, score=1.0,
                           meta={"tuned_at": 1.0, "provenance": "s0"})
        b = ScheduleRecord(op="y[]", target="t", config={"bm": 8}, score=2.0)
        a2 = ScheduleRecord(op="x[]", target="t", config={"bm": 4}, score=1.0,
                            meta={"tuned_at": 999.0})
        assert training_sha1([a, b]) == training_sha1([b, a2])
        assert training_sha1([a]) != training_sha1([b])

    def test_train_from_store_and_eval_quality(self, tmp_path):
        path = str(tmp_path / "db.jsonl")
        _seed_store(path, per_space=32)
        model, tsha, samples, skipped = train_from_store(path)
        assert samples == 64 and skipped == 0
        assert model.lineages == {measured_version(): 64}
        X, y, groups, _ = build_dataset(training_rows(iter_log_records(path)))
        rhos = []
        for g in set(groups):
            m = np.asarray([gi == g for gi in groups])
            rhos.append(spearman(model.predict(X[m]), np.log(y[m])))
        assert sum(rhos) / len(rhos) > 0.5

    def test_a_record_with_hlo_text_is_refused(self, tmp_path):
        """A store with a record that carries HLO text (``meta["hlo"]``)
        trains like any other, to the reference's ranker: the same
        fingerprint, version, training hash and counts (it was refused
        before the parser was ported)."""
        path = str(tmp_path / "db.jsonl")
        db = _seed_store(path, per_space=4)
        space = _space()
        db.add(ScheduleRecord(op=space.signature(), target=CPU.name,
                              config=space.default_config(), score=1.0,
                              meta={"hlo": jdist.TestHloParsing.HLO},
                              version=measured_version()))
        model, tsha, n, sk = train_from_store(path)
        jmodel, jtsha, jn, jsk = jtlearned.train_from_store(path)
        assert n == jn and n > 0
        assert model.fingerprint() == jmodel.fingerprint()
        assert (model.version, tsha, sk, model.lineages) == \
            (jmodel.version, jtsha, jsk, jmodel.lineages)

    def test_manager_ensure_on_change_and_publish(self, tmp_path):
        from repro_torch.tuna.transport import resolve_transport

        path = str(tmp_path / "db.jsonl")
        db = _seed_store(path)
        mgr = LearnedManager(path, str(tmp_path / "learned"))
        info = mgr.ensure()
        assert info.retrained and info.repointed
        assert os.path.exists(info.path) and os.path.exists(info.latest)
        assert load_ranker(info.latest).version == info.version
        again = mgr.ensure()
        assert not again.retrained and not again.repointed
        assert again.train_sha1 == info.train_sha1
        # restamped and reordered lines are not new content
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        for obj in lines:
            obj["meta"]["tuned_at"] = 5.0
        with open(path, "w") as f:
            f.writelines(json.dumps(obj) + "\n" for obj in reversed(lines))
        assert not mgr.ensure().retrained
        db = ScheduleDatabase(path)
        space = MatmulSpace(32, 32, 32, 4, target_kind="cpu")
        cfg = space.default_config()
        db.add(ScheduleRecord(op=space.signature(), target=CPU.name, config=cfg,
                              score=float(tuner._score_config(space, CPU, cfg)),
                              version=measured_version()))
        third = mgr.ensure()
        assert third.retrained and third.train_sha1 != info.train_sha1
        assert mgr.ensure(force=True).retrained
        t = resolve_transport(f"mem://port-learned-{os.getpid()}")
        manifests = mgr.publish(t)
        assert [m.name for m in manifests][1] == "learned.latest.json"

    def test_manager_pointer_is_the_reference_s(self, tmp_path):
        """Both managers on one store write the same artifact name and the
        same pointer fields (bar the build time)."""
        path = str(tmp_path / "db.jsonl")
        _seed_store(path)
        info = LearnedManager(path, str(tmp_path / "p")).ensure()
        jinfo = jtlearned.LearnedManager(path, str(tmp_path / "j")).ensure()
        assert info.name == jinfo.name and info.version == jinfo.version
        with open(info.latest) as f, open(jinfo.latest) as g:
            ptr, jptr = json.load(f), json.load(g)
        ptr.pop("built_at"), jptr.pop("built_at")
        assert ptr == jptr

    def test_manager_refuses_empty_store(self, tmp_path):
        path = str(tmp_path / "db.jsonl")
        ScheduleDatabase(path).add(ScheduleRecord(
            op="x[]", target="cpu_avx2", config={}, score=1.0, version="cm0"))
        with pytest.raises(ValueError, match="usable training sample"):
            LearnedManager(path, str(tmp_path / "learned")).ensure()

    def test_controller_retrains_and_publishes_on_change(self, tmp_path):
        """The port's copy of the reference's cell: the controller's
        reconcile retrains and republishes the learned ranker exactly when
        the store's training content changes."""
        from repro_torch.tuna.controller import ControllerConfig, FleetController

        path = str(tmp_path / "db.jsonl")
        db = _seed_store(path)
        cfg = ControllerConfig(db=path, ops=[], targets=[], num_shards=1,
                               learned_dir=str(tmp_path / "learned"),
                               publish=f"mem://port-ctl-learned-{os.getpid()}", quiet=True)
        ctl = FleetController(cfg, jobs=[])
        ctl.ensure_learned()
        assert ctl.metrics.get("learned_retrains_total") == 1
        assert ctl.metrics.get("learned_publishes_total") == 1
        ctl.ensure_learned()  # no change: no retrain, no republish
        assert ctl.metrics.get("learned_retrains_total") == 1
        assert ctl.metrics.get("learned_publishes_total") == 1
        space = MatmulSpace(32, 32, 32, 4, target_kind="cpu")
        cfg2 = space.default_config()
        db.add(ScheduleRecord(op=space.signature(), target=CPU.name, config=cfg2,
                              score=float(tuner._score_config(space, CPU, cfg2)),
                              version=measured_version()))
        ctl.ensure_learned()
        assert ctl.metrics.get("learned_retrains_total") == 2
        assert ctl.metrics.get("learned_publishes_total") == 2


# --------------------------------------------------------------------------
# the CLI's train and eval
# --------------------------------------------------------------------------


def _both_cli(args, capsys):
    """Exit codes of the port's and the reference's CLI on the same argv."""
    got = cli.main(args)
    capsys.readouterr()
    want = jcli.main(args)
    capsys.readouterr()
    return got, want


class TestCli:
    def test_train_eval_smoke(self, tmp_path, capsys):
        path = str(tmp_path / "db.jsonl")
        _seed_store(path, per_space=32)
        out_dir = str(tmp_path / "learned")
        assert cli.main(["train", "--db", path, "--dir", out_dir]) == 0
        assert "retrained" in capsys.readouterr().out
        latest = os.path.join(out_dir, "learned.latest.json")
        assert os.path.exists(latest)
        assert cli.main(["train", "--db", path, "--dir", out_dir]) == 0
        assert "up to date" in capsys.readouterr().out
        assert cli.main(["eval", "--db", path, "--model", latest,
                         "--check", "--min-spearman", "0.3"]) == 0
        assert "CHECK OK" in capsys.readouterr().out
        empty = str(tmp_path / "empty.jsonl")
        open(empty, "w").close()
        assert cli.main(["train", "--db", empty, "--dir", out_dir]) == 1

    @pytest.mark.parametrize("case", ["trained", "too-few-rows", "gate", "missing",
                                      "tampered", "empty-store"])
    def test_exit_codes_equal_the_reference_s(self, case, tmp_path, capsys):
        path = str(tmp_path / "db.jsonl")
        _seed_store(path, per_space=32)
        art_dir = str(tmp_path / "learned")
        assert cli.main(["train", "--db", path, "--dir", art_dir]) == 0
        latest = os.path.join(art_dir, "learned.latest.json")
        args = ["eval", "--db", path, "--model", latest]
        if case == "too-few-rows":
            small = str(tmp_path / "small.jsonl")
            _seed_store(small, spaces=(("cpu", 64),), per_space=2)
            args = ["eval", "--db", small, "--model", latest]
        elif case == "gate":
            args += ["--check", "--min-spearman", "1.01"]
        elif case == "missing":
            args = ["eval", "--db", path, "--model", str(tmp_path / "nope.json")]
        elif case == "tampered":
            _tamper(os.path.join(art_dir, json.load(open(latest))["artifact"]), True)
        elif case == "empty-store":
            empty = str(tmp_path / "empty.jsonl")
            open(empty, "w").close()
            args = ["train", "--db", empty, "--dir", str(tmp_path / "other")]
        got, want = _both_cli(args, capsys)
        assert got == want == (0 if case == "trained" else 1)

    def test_defaults_are_under_build(self, tmp_path, monkeypatch, capsys):
        """``train`` writes to build/learned of the working directory and
        ``eval`` reads from there: never the reference's experiments/."""
        path = str(tmp_path / "db.jsonl")
        _seed_store(path, per_space=32)
        monkeypatch.chdir(tmp_path)
        assert cli.main(["train", "--db", path]) == 0
        assert (tmp_path / "build" / "learned" / "learned.latest.json").exists()
        assert cli.main(["eval", "--db", path]) == 0
        assert not (tmp_path / "experiments").exists()
        capsys.readouterr()

    def test_tune_takes_the_reference_s_targets(self, tmp_path, capsys):
        db = str(tmp_path / "db.jsonl")
        assert cli.main(["tune", "--db", db, "--ops", "ssm_scan,dense_256",
                         "--targets", "tpu_v5e,cpu_avx2,gpu_a100,gpu_h100",
                         "--workers", "1", "--limit", "16"]) == 0
        recs = ScheduleDatabase(db).records()
        assert {r.target for r in recs} == {"tpu_v5e", "cpu_avx2", "gpu_a100", "gpu_h100"}
        assert cli.main(["tune", "--db", db, "--ops", "dense_256",
                         "--targets", "tpu_v4"]) == 2
        capsys.readouterr()


# --------------------------------------------------------------------------
# the top-k benchmark's options, on the CPU
# --------------------------------------------------------------------------


def test_topk_collect_learned_and_check_on_the_cpu(tmp_path):
    store = str(tmp_path / "db.jsonl")
    res = {}
    for m, n, k in topk_ratio.CPU_SHAPES + ((128, 128, 128),):
        res[(m, n, k)] = topk_ratio.topk_ratio_matmul(
            m, n, k, ks=(1, 5), iters=1, device="cpu", db=store, collect=True)
    rows = list(iter_log_records(store))
    meas = [r for r in rows if r.version == measured_version()]
    assert len(meas) == sum(r["n_configs"] for r in res.values())
    assert res[(128, 128, 128)]["collected"] == 16
    assert {r.meta["strategy"] for r in rows if r.version == "cm1"} == {"topk_static"}
    model = train_from_store(store)[0]
    base = res[(128, 128, 128)]
    hyb = topk_ratio.topk_ratio_matmul(128, 128, 128, ks=(1, 5), device="cpu",
                                       learned=model, measured=base["ranking"])
    for key in ("hybrid_ratio@1", "hybrid_ratio@5", "hybrid_top1_ratio",
                "hybrid_rank_corr", "learned_version", "hybrid_s"):
        assert key in hyb, key
    assert hyb["ratio@5"] == pytest.approx(base["ratio@5"], rel=1e-12)
    assert hyb["hybrid_ratio@1"] == hyb["hybrid_top1_ratio"] <= 1.0
    assert sorted(map(str, hyb["hybrid_ranking"])) == \
        sorted(str(e["config"]) for e in base["ranking"])
    assert hyb["learned_version"] == model.version
    check = topk_ratio.check_hybrid({"s": hyb})
    assert check["ok"] == (check["hybrid_mean_ratio"] >= check["static_mean_ratio"] - 1e-9)
    with pytest.raises(ValueError, match="collect"):
        topk_ratio.topk_ratio_matmul(128, 128, 128, device="cpu", db=store,
                                     collect=True, measured=base["ranking"])
    with pytest.raises(ValueError, match="not this call's sample"):
        topk_ratio.topk_ratio_matmul(128, 128, 128, device="cpu", n_configs=4,
                                     measured=base["ranking"])


def test_topk_writes_a_sample_version_for_a_sampled_space(tmp_path):
    store = str(tmp_path / "db.jsonl")
    res = topk_ratio.topk_ratio_matmul(128, 128, 128, n_configs=5, ks=(1,), iters=1,
                                       device="cpu", db=store)
    assert res["n_configs"] == 5 < res["space_size"]
    (rec,) = ScheduleDatabase(store).records()
    assert rec.version == "cm1-sample"
    again = topk_ratio.topk_ratio_matmul(128, 128, 128, n_configs=5, ks=(1,), iters=1,
                                         device="cpu", db=store)
    assert again["warm_config"] == rec.config


def test_topk_calibrated_reads_the_card_s_fit(tmp_path):
    """calibrated=True scores with the cached fit of this device, under its
    cm1-cal lineage; the ranking is a permutation of the same configs."""
    fit = calibrate.cached_coeffs("gpu_h100", "cpu", probe=(128, 128, 128), iters=1)
    coeffs = calibrate.coeffs_for_scoring(fit)
    base = topk_ratio.topk_ratio_matmul(128, 128, 128, ks=(1, 5), iters=1, device="cpu")
    cal = topk_ratio.topk_ratio_matmul(128, 128, 128, ks=(1, 5), device="cpu",
                                       calibrated=True, measured=base["ranking"])
    assert cal["coeffs_version"] == tuner.record_version(coeffs)
    assert [e["score"] for e in cal["ranking"]] == sorted(e["score"] for e in cal["ranking"])
    space = MatmulSpace(128, 128, 128, 2, "sm90")
    assert cal["ranking"][0]["score"] == tuner.rank_space(space, GPU_H100, coeffs=coeffs)[0][1]


def test_three_way_trains_each_hybrid_without_its_own_shape(tmp_path):
    store = str(tmp_path / "db.jsonl")
    calibrate.cached_coeffs("gpu_h100", "cpu", probe=(128, 128, 128), iters=1, db=store)
    shapes = ((64, 128, 64), (128, 64, 128), (128, 256, 128))
    measured = {s: topk_ratio.topk_ratio_matmul(*s, ks=(1, 5), iters=1, device="cpu",
                                                db=store, collect=True) for s in shapes}
    out, check = topk_ratio.three_way(measured, store, tmp_path / "work", device="cpu")
    probe_sig = MatmulSpace(128, 128, 128, 2, "sm90").signature()
    for (m, n, k), row in zip(shapes, out.values()):
        sig = MatmulSpace(m, n, k, 2, "sm90").signature()
        assert sig not in row["train_ops"] and probe_sig in row["train_ops"]
        assert len(row["train_ops"]) == len(shapes)  # the two others + the probe
        for how in ("static", "calibrated", "hybrid"):
            assert set(row[how]) >= {"top1", "rank_corr"}
            assert 0 < row[how]["top1"] <= 1.0
        assert row["learned_version"].startswith("cm1+lr")
    assert set(check) >= {"ok", "static_mean_ratio", "hybrid_mean_ratio"}


def test_topk_command_line_options(tmp_path, capsys):
    store = str(tmp_path / "db.jsonl")
    out = tmp_path / "topk.json"
    assert topk_ratio.main(["--device", "cpu", "--shape", "128", "128", "128",
                            "--iters", "1", "--db", store, "--collect"]) == 0
    art = str(tmp_path / "m.json")
    save_ranker(train_from_store(store)[0], art)
    rc = topk_ratio.main(["--device", "cpu", "--shape", "128", "128", "128",
                          "--iters", "1", "--learned", art, "--check",
                          "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == (0 if res["check"]["ok"] else 1)
    assert "hybrid_ratio@1" in res["results"]["128x128x128"]
    with pytest.raises(SystemExit):
        topk_ratio.main(["--device", "cpu", "--check"])
    with pytest.raises(SystemExit):
        topk_ratio.main(["--device", "cpu", "--collect"])
    capsys.readouterr()


# --------------------------------------------------------------------------
# the port's copies of TestCalibration and TestOperatorSpaces
# (tests/test_tuna_extra.py), TestSmokeTuneAllTargets and
# TestLearnedFeatureLayout (tests/test_op_registry.py)
# --------------------------------------------------------------------------


class TestCalibration:
    def test_nnls_nonnegative_and_fits(self):
        rng = np.random.default_rng(0)
        A = np.abs(rng.standard_normal((40, 4)))
        y = A @ np.array([0.5, 0.0, 2.0, 0.1])
        x = calibrate._nnls(A, y, iters=5000)
        assert (x >= 0).all()
        np.testing.assert_allclose(A @ x, y, rtol=0.2, atol=0.1)

    def test_coeffs_for_scoring_shape(self):
        c = calibrate.coeffs_for_scoring({
            "ilp_cycles": 1e-9, "movement_bytes": 1e-10, "arith_ops": 0.0,
            "ldst_ops": 0.0, "dispatch_calls": 1e-6, "intercept": 0.0})
        assert c["vmem_overflow"] == 1.0
        assert set(c) == set(cost_model.coefficients(CPU))


class TestOperatorSpaces:
    @pytest.mark.parametrize("name", sorted(OPERATORS))
    def test_cpu_spaces_instantiate_and_score(self, name):
        space = OPERATORS[name]("cpu")
        prog, meta = space.instantiate(space.default_config())
        score = cost_model.evaluate(prog, CPU, meta)
        assert np.isfinite(score) and score > 0

    @pytest.mark.parametrize("name", ["dense_512", "conv2d", "batch_matmul"])
    def test_tpu_spaces_rank(self, name):
        ranked = tuner.rank_space(OPERATORS[name]("tpu"), TPU, limit=64)
        assert len(ranked) >= 2 and ranked[0][1] <= ranked[-1][1]

    def test_depthwise_is_vpu_only(self):
        from repro_torch.core import instcount, visa

        space = OPERATORS["depthwise_conv2d"]("tpu")
        prog, meta = space.instantiate(space.default_config())
        f = cost_model.extract_features(prog, TPU, meta)
        rep = instcount.count_instructions(prog, visa.lower_program(prog, TPU))
        assert rep.counts.get("mxu.matmul", 0) == 0
        assert f.arith_ops > 0


ALL_TARGETS = ("tpu_v5e", "cpu_avx2", "gpu_a100", "gpu_h100")


class TestSmokeTuneAllTargets:
    @pytest.mark.parametrize("family", sorted(op_registry.families()))
    def test_family_tunes_on_all_targets(self, family, tmp_path):
        """One preset per family, tuned with a tiny ES budget on the
        reference's three targets and the H100: a record lands in the DB
        under the registry signature."""
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        _, preset = next(v for v in op_registry.all_presets().values() if v[0] == family)
        for target_name in ALL_TARGETS:
            target = get_target(target_name)
            sp = op_registry.make_space(family, preset.attrs, target.kind)
            res = tuner.tune(sp, target, iterations=2, population=4, workers=1, db=db)
            assert 0 < res.score < float("inf")
            rec = db.best(sp.signature(), target.name)
            assert rec is not None and rec.config == res.config

    def test_zoo_operators_are_the_reference_s(self):
        from repro.configs.tuna_ops import ZOO_OPERATORS as JZOO

        assert ZOO_OPERATORS == JZOO
        assert set(ZOO_OPERATORS) <= set(OPERATORS)


class TestLearnedFeatureLayout:
    def test_knob_union_keeps_legacy_prefix(self):
        names = [kf.name for kf in op_registry.knob_feature_union()]
        legacy = ["bm", "bn", "bk", "b_oc", "b_ow", "b_ic", "b_c"]
        assert names[:len(legacy)] == legacy
