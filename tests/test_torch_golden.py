"""The port's golden releases and kernel bundles (``repro_torch.tuna.golden``,
the bundle tier of ``repro_torch.core.tuner``, the bundle dispatch of
``kernels/ops``, the ``golden`` CLI and the serve's ``--kernel-bundle``)
held to the reference's contract, case for case: the cases of
``tests/test_golden.py`` on the port's target ``gpu_h100`` with CPU
bundles (f32 records, entries that run the plain versions), then the two
packages against each other: each reads the other's golden release with
the same digest and the same gate result, and each refuses the other's
kernel bundle by its backend. ``kernels/build.py``'s prebuilt-library
install and nvcc count are held here with a stand-in for the library; the
cases that need the card (a CUDA bundle built, installed and launched with
no nvcc run) are in ``tests/test_torch_cuda.py``.

The reference's ``TestBundleDispatch::test_tracer_args_fall_through_to_
trace_path`` has no counterpart: torch has no tracers, and a bundle entry
is called on concrete tensors only. Its ``TestColdStartBench`` waits with ``benchmarks/cold_start.py`` (ROADMAP
Queue A 1), whose gates ``chip_smoke.py``'s ``golden-bundle`` phase holds
on the card meanwhile.
"""
import dataclasses
import json
import os
import re
import types

import numpy as np
import jax
import pytest
import torch

from repro.tuna import golden as jgolden
from repro.tuna.db import ScheduleRecord as JRecord
from repro_torch.core import op_registry, tuner
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import matmul as kmatmul
from repro_torch.tuna import cli
from repro_torch.tuna.cache import (ScheduleCache, StaleSnapshotError,
                                    StaleSnapshotWarning)
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord
from repro_torch.tuna.golden import (
    BundleError,
    GoldenError,
    GoldenManager,
    GoldenRegressionError,
    KernelBundle,
    build_kernel_bundle,
    plan_bundle_entries,
)
from repro_torch.tuna.transport import MemoryTransport

MM_OP = "matmul[K=128,M=128,N=128,dtype_bytes=4]"
FL_OP = "flash[d=64,dtype_bytes=4,s=128]"
TGT = "gpu_h100"
RNG = np.random.default_rng(3)


@pytest.fixture(autouse=True)
def _port_store_off(monkeypatch):
    """The port's process defaults (DB, snapshot, bundle) off around every
    test, whatever the env variables say, and the memos cleared."""
    for var in ("REPRO_TUNA_DB", "REPRO_TUNA_CACHE", "REPRO_TUNA_BUNDLE"):
        monkeypatch.delenv(var, raising=False)
    tuner.set_default_db(None)
    tuner.set_default_cache(None)
    tuner.set_default_bundle(None)
    yield
    tuner.set_default_db(None)
    tuner.set_default_cache(None)
    tuner.set_default_bundle(None)


def mk_records(mm_score=1e-6, fl_score=2e-6, with_flash=True,
               with_conv=True, cls=ScheduleRecord):
    recs = [cls(op=MM_OP, target=TGT, score=mm_score,
                config={"bm": 64, "bn": 64, "bk": 64})]
    if with_flash:
        recs.append(cls(op=FL_OP, target=TGT, score=fl_score,
                        config={"block_q": 64, "block_k": 64}))
    if with_conv:
        # rides in the schedule index but has no kernel to bundle
        recs.append(cls(op="conv2d[foo=1]", target=TGT, config={"x": 1},
                        score=3e-6))
    return recs


def _mem(tmp_path) -> MemoryTransport:
    bucket = f"port-golden-{os.path.basename(tmp_path)}"
    MemoryTransport.wipe(bucket)
    return MemoryTransport(bucket)


def _t(shape):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))


class TestGoldenLifecycle:
    def test_promote_reload_and_noop_repromote(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        info = mgr.promote(mk_records(), TGT, source="unit")
        assert info.rebuilt and info.repointed
        assert info.predecessor is None and info.count == 3
        assert os.path.exists(info.path) and os.path.exists(info.latest)
        hdr, records = mgr.load_release(info.latest)  # follows the pointer
        assert hdr["sha1"] == info.sha1 and len(records) == 3
        assert hdr["source"] == "unit"
        # the stamp at a fixed width: seconds with exactly three decimals
        assert re.search(r'"built_at": \d+\.\d{3},', open(info.path).read())
        again = mgr.promote(mk_records(), TGT)
        assert not again.rebuilt and not again.repointed
        assert again.name == info.name

    def test_improvement_promotes_and_links_predecessor(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        first = mgr.promote(mk_records(mm_score=2e-6), TGT)
        second = mgr.promote(mk_records(mm_score=1e-6), TGT)
        assert second.rebuilt and second.name != first.name
        assert second.predecessor == first.name
        assert second.gated_against == 3
        hdr, _ = mgr.load_release(second.path)
        assert hdr["predecessor"] == first.name
        assert mgr.current(TGT)["release"] == second.name

    def test_gate_refuses_slower_schedule(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        first = mgr.promote(mk_records(mm_score=1e-6), TGT)
        with pytest.raises(GoldenRegressionError) as ei:
            mgr.promote(mk_records(mm_score=5e-6), TGT)
        (reg,) = ei.value.regressions
        assert reg.kind == "slower" and reg.op == MM_OP
        assert reg.old_score == 1e-6 and reg.new_score == 5e-6
        # refused promotion must leave the blessed pointer untouched
        assert mgr.current(TGT)["release"] == first.name

    def test_gate_refuses_lost_coverage(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        mgr.promote(mk_records(), TGT)
        with pytest.raises(GoldenRegressionError) as ei:
            mgr.promote(mk_records(with_flash=False), TGT)
        (reg,) = ei.value.regressions
        assert reg.kind == "lost" and reg.op == FL_OP

    def test_waiver_promotes_and_is_recorded(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        mgr.promote(mk_records(mm_score=1e-6), TGT)
        spec = f"{MM_OP}@{TGT}"
        info = mgr.promote(mk_records(mm_score=5e-6), TGT, waive=[spec])
        assert len(info.waived) == 1 and info.waived[0].waived_by == spec
        hdr, _ = mgr.load_release(info.path)
        (w,) = hdr["waivers"]
        assert w["waived_by"] == spec and w["kind"] == "slower"
        assert w["old_score"] == 1e-6 and w["new_score"] == 5e-6

    def test_waiver_does_not_cover_other_regressions(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        mgr.promote(mk_records(), TGT)
        with pytest.raises(GoldenRegressionError) as ei:
            mgr.promote(mk_records(mm_score=5e-6, with_flash=False), TGT,
                        waive=[f"{MM_OP}@{TGT}"])
        (reg,) = ei.value.regressions  # matmul waived, flash loss still blocks
        assert reg.op == FL_OP and reg.kind == "lost"

    def test_cost_model_bump_starts_fresh_lineage(self, tmp_path,
                                                  monkeypatch):
        mgr = GoldenManager(str(tmp_path))
        mgr.promote(mk_records(mm_score=1e-6), TGT)
        monkeypatch.setattr("repro_torch.tuna.golden.COST_MODEL_VERSION",
                            "cm99")
        recs = [dataclasses.replace(r, version="cm99")
                for r in mk_records(mm_score=9e-6)]
        info = mgr.promote(recs, TGT)  # slower, but scores aren't comparable
        assert info.predecessor is None and info.gated_against == 0
        assert ".cm99-" in info.name

    def test_corrupt_release_refused(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        info = mgr.promote(mk_records(), TGT)
        obj = json.load(open(info.path))
        obj["records"][0]["score"] = 0.5  # tamper past the gate
        json.dump(obj, open(info.path, "w"))
        with pytest.raises(GoldenError, match="digest mismatch"):
            mgr.load_release(info.path)

    def test_nothing_to_promote(self, tmp_path):
        mgr = GoldenManager(str(tmp_path))
        with pytest.raises(GoldenError, match="nothing to promote"):
            mgr.promote(mk_records(), "tpu_v4")  # no records for the target


@pytest.fixture(scope="module")
def built_bundle(tmp_path_factory):
    """One promoted golden + CPU bundle shared by the read-only tests."""
    d = str(tmp_path_factory.mktemp("bundle"))
    mgr = GoldenManager(d)
    info = mgr.promote(mk_records(), TGT, source="fixture")
    _, release = mgr.load_release(info.path)
    binfo = build_kernel_bundle(release, d, TGT, golden_name=info.name,
                                device="cpu")
    return mgr, info, binfo


class TestKernelBundle:
    def test_plan_partitions_records(self):
        plans, skipped = plan_bundle_entries(mk_records(), device="cpu")
        assert sorted(p.kernel for p in plans) == ["flash", "matmul"]
        (skip,) = skipped
        assert skip[0] == "conv2d[foo=1]" and "no kernel" in skip[1]

    def test_cuda_plan_keeps_f32_records_index_only(self):
        """The Hopper kernels take bf16 and f32 (and f16, which no record's
        signature names): a CUDA bundle plans the f32 records beside the
        bf16 ones, 16-bit head dims past 128 among them (the wide builds)
        and past 256 (the chunked ones), and keeps in its schedule index
        only, as skips with their reason, the records no kernel is built
        for: an f32 matmul whose two stages exceed shared memory, an f32
        flash record at blocks whose tiles do not fit, and a
        head dim past 512."""
        bf16 = ScheduleRecord(op="matmul[K=256,M=256,N=256,dtype_bytes=2]",
                              target=TGT, score=1e-6,
                              config={"bm": 128, "bn": 128, "bk": 64,
                                      "double_buffer": True})
        big = ScheduleRecord(op="matmul[K=256,M=256,N=256,dtype_bytes=4]",
                             target=TGT, score=1e-6,
                             config={"bm": 128, "bn": 128, "bk": 128,
                                     "double_buffer": True})
        wide = ScheduleRecord(op="flash[d=128,dtype_bytes=4,s=256]", target=TGT,
                              score=1e-6, config={"block_q": 128, "block_k": 128})
        d136 = ScheduleRecord(op="flash[d=136,dtype_bytes=2,s=256]", target=TGT,
                              score=1e-6, config={"block_q": 64, "block_k": 64})
        d264 = ScheduleRecord(op="flash[d=264,dtype_bytes=2,s=256]", target=TGT,
                              score=1e-6, config={"block_q": 64, "block_k": 64})
        d520 = ScheduleRecord(op="flash[d=520,dtype_bytes=2,s=256]", target=TGT,
                              score=1e-6, config={"block_q": 64, "block_k": 64})
        plans, skipped = plan_bundle_entries(
            mk_records() + [bf16, big, wide, d136, d264, d520], device="cuda")
        assert sorted(p.record.op for p in plans) == sorted([MM_OP, FL_OP, bf16.op,
                                                             d136.op, d264.op])
        why = dict(skipped)
        assert "shared memory" in why[big.op]
        assert "not built for torch.float32" in why[wide.op]
        assert "head dim 520" in why[d520.op]
        assert "no kernel" in why["conv2d[foo=1]"]
        # each plan launches from its entry point's library
        from repro_torch.tuna.golden import _library

        libs = {p.record.op: _library(p.kernel, p.in_avals) for p in plans}
        assert libs == {MM_OP: "matmul", FL_OP: "flash_attention", bf16.op: "matmul",
                        d136.op: "flash_attention_wide", d264.op: "flash_attention_chunked"}

    @pytest.mark.parametrize("kernel,avals,config,ok", [
        # the tune --smoke store's dense_256 matmul record at 4 bytes
        ("matmul", [((256, 256), "float32"), ((256, 256), "float32")],
         {"bm": 64, "bn": 64, "bk": 64, "double_buffer": True}, True),
        # the reduced configs' attention: f32 and bf16 at head dim 16
        ("flash", [((1, 4, 64, 16), "float32"), ((1, 2, 64, 16), "float32"),
                   ((1, 2, 64, 16), "float32")], {"block_q": 64, "block_k": 64}, True),
        ("flash", [((1, 4, 64, 16), "bfloat16"), ((1, 2, 64, 16), "bfloat16"),
                   ((1, 2, 64, 16), "bfloat16")], {"block_q": 128, "block_k": 128}, True),
        # admitted since the f16 kernels and the wide builds: bf16 at D=136,
        # f16 matmul and flash
        ("flash", [((1, 4, 64, 136), "bfloat16"), ((1, 2, 64, 136), "bfloat16"),
                   ((1, 2, 64, 136), "bfloat16")], {"block_q": 64, "block_k": 64}, True),
        ("matmul", [((256, 256), "float16"), ((256, 256), "float16")],
         {"bm": 64, "bn": 64, "bk": 64, "double_buffer": True}, True),
        ("flash", [((1, 4, 64, 16), "float16"), ((1, 2, 64, 16), "float16"),
                   ((1, 2, 64, 16), "float16")], {"block_q": 64, "block_k": 64}, True),
        # skipped: inputs of two dtypes
        ("matmul", [((256, 256), "float32"), ((256, 256), "bfloat16")],
         {"bm": 64, "bn": 64, "bk": 64, "double_buffer": True}, False),
        # admitted since f32 flash past 128, 16 bits past 256 and the
        # staging copy (a head dim, N or K TMA cannot stride)
        ("flash", [((1, 4, 64, 136), "float32"), ((1, 2, 64, 136), "float32"),
                   ((1, 2, 64, 136), "float32")], {"block_q": 64, "block_k": 64}, True),
        ("flash", [((1, 4, 64, 264), "float16"), ((1, 2, 64, 264), "float16"),
                   ((1, 2, 64, 264), "float16")], {"block_q": 64, "block_k": 64}, True),
        ("flash", [((1, 4, 64, 20), "bfloat16"), ((1, 2, 64, 20), "bfloat16"),
                   ((1, 2, 64, 20), "bfloat16")], {"block_q": 64, "block_k": 64}, True),
        # still skipped: blocks that do not fit, the ceilings, f64
        ("flash", [((1, 4, 64, 256), "float16"), ((1, 2, 64, 256), "float16"),
                   ((1, 2, 64, 256), "float16")], {"block_q": 64, "block_k": 128}, False),
        ("flash", [((1, 4, 64, 16), "float64"), ((1, 2, 64, 16), "float64"),
                   ((1, 2, 64, 16), "float64")], {"block_q": 64, "block_k": 64}, False),
        ("matmul", [((256, 100), "bfloat16"), ((100, 36), "bfloat16")],
         {"bm": 64, "bn": 64, "bk": 128, "double_buffer": True}, True),
        ("flash", [((1, 4, 64, 520), "bfloat16"), ((1, 2, 64, 520), "bfloat16"),
                   ((1, 2, 64, 520), "bfloat16")], {"block_q": 64, "block_k": 64}, False),
        ("flash", [((1, 4, 64, 264), "float32"), ((1, 2, 64, 264), "float32"),
                   ((1, 2, 64, 264), "float32")], {"block_q": 64, "block_k": 64}, False),
        ("flash", [((1, 4, 64, 192), "float32"), ((1, 2, 64, 192), "float32"),
                   ((1, 2, 64, 192), "float32")], {"block_q": 128, "block_k": 64}, False),
        # a stored f32 pick from sources that built (128, 64) at 128 columns:
        # no CUDA bundle entry (the schedule index keeps it; the picker
        # passes it over)
        ("flash", [((1, 4, 1024, 128), "float32"), ((1, 2, 1024, 128), "float32"),
                   ((1, 2, 1024, 128), "float32")], {"block_q": 128, "block_k": 64}, False),
    ])
    def test_cuda_skip_admits_f32_and_other_head_dims(self, kernel, avals, config, ok):
        """``_cuda_skip`` admits what a kernel is built for and states why
        it skips the rest."""
        from repro_torch.tuna.golden import _cuda_skip

        why = _cuda_skip(kernel, avals, config)
        assert (why is None) is ok
        if not ok:
            assert why

    def test_f16_call_misses_a_bundle_of_bf16_records(self, tmp_path, monkeypatch):
        """A bundle made from bf16 records keys its entries by "bfloat16":
        an f16 call of the same shape misses every entry, takes the record's
        blocks from the bundle's schedule index (f16 has bf16's width) and
        runs the f16 path: the plain version here, on the card the f16
        kernel from matmul_f16's library (``_library``). No entry's callable
        is ever made for f16 data, so no bf16 code sees it."""
        from repro_torch.tuna.golden import _library

        mm = ScheduleRecord(op="matmul[K=128,M=128,N=256,dtype_bytes=2]", target=TGT,
                            score=1e-6, config={"bm": 64, "bn": 128, "bk": 64,
                                                "double_buffer": True})
        fl = ScheduleRecord(op="flash[d=64,dtype_bytes=2,s=128]", target=TGT,
                            score=2e-6, config={"block_q": 128, "block_k": 64})
        mgr = GoldenManager(str(tmp_path))
        info = mgr.promote([mm, fl], TGT, source="bf16")
        _, release = mgr.load_release(info.path)
        binfo = build_kernel_bundle(release, str(tmp_path), TGT, golden_name=info.name,
                                    device="cpu")
        bundle = KernelBundle.load(binfo.path, device="cpu")
        assert binfo.entries == 2
        tuner.set_default_bundle(bundle)
        x, y = _t((128, 128)).half(), _t((128, 256)).half()
        got = ops.matmul(x, y)
        assert (bundle.exec_hits, bundle.exec_misses) == (0, 1)
        assert got.dtype == torch.float16
        assert torch.equal(got, kmatmul.matmul_plain(x, y, 64, 128, 64))
        q = _t((1, 1, 128, 64)).half()  # the shape the flash record's entry has
        out = ops.attention(q, q, q)
        assert (bundle.exec_hits, bundle.exec_misses) == (0, 2)
        assert torch.equal(out, kflash.flash_attention_plain(q, q, q, block_q=128,
                                                            block_k=64))
        # the same shapes in bf16 hit their entries
        ops.matmul(x.bfloat16(), y.bfloat16())
        ops.attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
        assert (bundle.exec_hits, bundle.exec_misses) == (2, 2)
        assert all('"bfloat16"' in key for key in bundle._loaded)
        # on the card the f16 calls launch from the f16 libraries
        assert _library("matmul", [((128, 128), "float16"), ((128, 256), "float16")]) \
            == "matmul_f16"
        assert _library("flash", [((1, 1, 128, 64), "float16")] * 3) == "flash_attention_f16"
        assert kmatmul.ENTRY[torch.float16] == "matmul_f16"

    def test_cuda_bundle_build_needs_nvcc(self, tmp_path, monkeypatch):
        import torch.utils.cpp_extension as cpp_ext

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
        monkeypatch.setattr(build.shutil, "which", lambda *_: None)
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc"):
            build_kernel_bundle(mk_records(), str(tmp_path), TGT)
        assert not list(tmp_path.glob("bundle.*"))

    def test_build_load_execute(self, built_bundle):
        _, info, binfo = built_bundle
        assert binfo.entries == 2 and binfo.schedules == 3
        assert binfo.libraries == {}  # a CPU bundle carries no library
        bundle = KernelBundle.load(binfo.path, device="cpu")
        assert len(bundle) == 2 and bundle.golden == info.name
        assert bundle.backend == "torch-cpu"
        x, y = _t((128, 128)), _t((128, 128))
        fn = bundle.executable("matmul", (x, y))
        assert fn is not None
        np.testing.assert_allclose(fn(x, y).numpy(), x.numpy() @ y.numpy(),
                                   rtol=1e-5, atol=1e-4)
        # bit for bit the plain version at the record's blocks
        assert torch.equal(fn(x, y), kmatmul.matmul_plain(x, y, 64, 64, 64))
        q = _t((1, 1, 128, 64))
        att = bundle.executable("flash", (q, q, q),
                                {"causal": True, "scale": 64 ** -0.5})
        assert att is not None
        assert torch.equal(att(q, q, q), kflash.flash_attention_plain(
            q, q, q, causal=True, block_q=64, block_k=64))
        assert bundle.exec_hits == 2
        # unknown shape, another dtype, another device type: misses
        small = torch.ones((8, 8))
        assert bundle.executable("matmul", (small, small)) is None
        assert bundle.executable("matmul", (x.double(), y.double())) is None
        meta = torch.empty((128, 128), device="meta")
        assert bundle.executable("matmul", (meta, meta)) is None
        assert bundle.exec_misses == 3

    def test_schedule_tier_and_immutability(self, built_bundle):
        _, _, binfo = built_bundle
        bundle = KernelBundle.load(binfo.path, device="cpu")
        rec = bundle.best(FL_OP, TGT)
        assert rec.config == {"block_q": 64, "block_k": 64}
        # the non-kernel record still rides in the schedule index
        assert bundle.best("conv2d[foo=1]", TGT) is not None
        assert bundle.best("nope[]", TGT) is None
        assert bundle.hits == 2 and bundle.misses == 1
        with pytest.raises(TypeError):
            bundle.add(None)

    def test_latest_pointer_followed(self, built_bundle):
        _, _, binfo = built_bundle
        via_ptr = KernelBundle.load(binfo.latest, device="cpu")
        assert via_ptr.sha1 == binfo.sha1

    def _tampered(self, binfo, tmp_path, **header_edits):
        obj = json.load(open(binfo.path))
        obj.update(header_edits)
        path = str(tmp_path / "tampered.json")
        json.dump(obj, open(path, "w"))
        return path

    def test_load_refuses_torn_copy(self, built_bundle, tmp_path):
        _, _, binfo = built_bundle
        obj = json.load(open(binfo.path))
        obj["schedules"][0]["score"] = 0.5  # payload edit breaks the digest
        path = str(tmp_path / "torn.json")
        json.dump(obj, open(path, "w"))
        with pytest.raises(BundleError, match="digest mismatch"):
            KernelBundle.load(path, device="cpu")
        text = open(binfo.path).read()
        with open(path, "w") as f:
            f.write(text[: len(text) // 2])  # a truncated copy
        with pytest.raises(BundleError, match="not JSON"):
            KernelBundle.load(path, device="cpu")

    def test_load_refuses_stale_cost_model(self, built_bundle, tmp_path):
        _, _, binfo = built_bundle
        path = self._tampered(binfo, tmp_path, cost_model_version="cm0")
        with pytest.raises(StaleSnapshotError):
            KernelBundle.load(path, device="cpu")

    @pytest.mark.parametrize("backend,device", [
        ("tpu", "cpu"),          # the reference's own test
        ("torch-cuda", "cpu"),   # a CUDA bundle in a process on the CPU
        ("torch-cpu", "cuda"),   # a CPU bundle in a process on the card
    ])
    def test_load_refuses_foreign_backend(self, built_bundle, tmp_path,
                                          backend, device):
        _, _, binfo = built_bundle
        path = self._tampered(binfo, tmp_path, backend=backend)
        with pytest.raises(BundleError, match="backend"):
            KernelBundle.load(path, device=device)

    def test_load_refuses_other_kernel_sources(self, built_bundle, tmp_path):
        _, _, binfo = built_bundle
        assert json.load(open(binfo.path))["source_digest"] == \
            build.source_digest()
        path = self._tampered(binfo, tmp_path, source_digest="0" * 12)
        with pytest.raises(BundleError, match="kernel sources"):
            KernelBundle.load(path, device="cpu")

    def test_load_refuses_wrong_schema(self, built_bundle):
        _, info, _ = built_bundle
        with pytest.raises(BundleError, match="not a kernel bundle"):
            KernelBundle.load(info.path, device="cpu")  # a release


class TestBundleDispatch:
    def test_zero_build_dispatch_with_numeric_parity(self, built_bundle,
                                                     monkeypatch):
        """A hit launches the bundled entry at the record's blocks: no
        picker is called, nothing is built, and the output is bit for bit
        the explicit-blocks call's."""
        _, _, binfo = built_bundle
        x, y = _t((128, 128)), _t((128, 128))
        q = _t((1, 1, 128, 64))
        base_mm = ops.matmul(x, y, blocks=(64, 64, 64))
        base_att = ops.attention(q, q, q, blocks=(64, 64))
        ops.use_kernel_bundle(binfo.path, device="cpu")
        builds = ops.kernel_build_counts()

        def no_pick(*a, **kw):
            raise AssertionError("a bundle hit called a block picker")

        monkeypatch.setattr(ops, "tuned_matmul_blocks", no_pick)
        monkeypatch.setattr(ops, "tuned_flash_blocks", no_pick)
        got_mm = ops.matmul(x, y)
        got_att = ops.attention(q, q, q)
        assert ops.kernel_build_counts() == builds
        assert ops.get_kernel_bundle().exec_hits == 2
        assert torch.equal(got_mm, base_mm)
        assert torch.equal(got_att, base_att)

    def test_without_bundle_the_picker_runs(self, monkeypatch):
        picks = []
        real = ops.tuned_matmul_blocks

        def counting(*a):
            picks.append(a)
            return real(*a)

        monkeypatch.setattr(ops, "tuned_matmul_blocks", counting)
        x = torch.ones((128, 128))
        ops.matmul(x, x)
        assert picks == [(128, 128, 128, 4)]

    def test_bundle_is_first_schedule_tier(self, built_bundle):
        _, _, binfo = built_bundle
        ops.use_kernel_bundle(binfo.path, device="cpu")
        assert ops.tuned_flash_blocks(128, 64, 4) == (64, 64)
        bundle = ops.get_kernel_bundle()
        assert bundle.hits >= 1
        rec, source = tuner._lookup(MM_OP, TGT, COST_MODEL_VERSION, None)
        assert source == "bundle" and rec.score == 1e-6

    def test_bundle_hit_sets_from_cache(self, built_bundle):
        from repro_torch.core.spaces import MatmulSpace
        from repro_torch.hw.gpu_h100 import GPU_H100

        space = MatmulSpace(128, 128, 128, 4, target_kind=GPU_H100.kind)
        assert space.signature() == MM_OP
        _, _, binfo = built_bundle
        ops.use_kernel_bundle(binfo.path, device="cpu")
        res = tuner.tune(space, GPU_H100)
        assert res.from_db and res.from_cache and res.evaluations == 0

    def test_env_var_fallback_and_stale_degrade(self, built_bundle,
                                                tmp_path, monkeypatch):
        _, _, binfo = built_bundle
        monkeypatch.setattr(tuner, "BUNDLE_DEVICE", "cpu")
        monkeypatch.setenv("REPRO_TUNA_BUNDLE", binfo.path)
        monkeypatch.setattr(tuner, "_DEFAULT_BUNDLE", tuner._UNSET)
        assert tuner.get_default_bundle() is not None
        # a path not built yet resolves to OFF
        monkeypatch.setenv("REPRO_TUNA_BUNDLE", str(tmp_path / "none.json"))
        monkeypatch.setattr(tuner, "_DEFAULT_BUNDLE", tuner._UNSET)
        assert tuner.get_default_bundle() is None
        # a stale bundle degrades to OFF loudly and clears the memos
        obj = json.load(open(binfo.path))
        obj["cost_model_version"] = "cm0"
        stale = str(tmp_path / "stale_bundle.json")
        json.dump(obj, open(stale, "w"))
        cleared = []
        tuner.register_memo_clearer(lambda: cleared.append(1))
        try:
            monkeypatch.setenv("REPRO_TUNA_BUNDLE", stale)
            monkeypatch.setattr(tuner, "_DEFAULT_BUNDLE", tuner._UNSET)
            with pytest.warns(StaleSnapshotWarning,
                              match="REPRO_TUNA_BUNDLE disabled"):
                assert tuner.get_default_bundle() is None
            assert cleared
        finally:
            tuner._MEMO_CLEARERS.pop()


class _FakeLibrary:
    """Stands in for ``ctypes.CDLL``: records the path it was opened from
    and offers the kernels' entry points as plain attribute holders."""

    opened = []

    def __init__(self, path):
        self.path = path
        _FakeLibrary.opened.append(path)
        self.matmul_bf16 = types.SimpleNamespace()
        self.flash_attention_fwd_bf16 = types.SimpleNamespace()


class TestPrebuiltLibraries:
    @pytest.fixture
    def fake_libs(self, monkeypatch):
        built = []
        monkeypatch.setattr(build.ctypes, "CDLL", _FakeLibrary)
        monkeypatch.setattr(build, "build", lambda names=None: built.extend(names))
        _FakeLibrary.opened = []
        build._clear_loaded()
        yield built
        for name in list(build.installed()):
            build.uninstall(name)
        build._clear_loaded()

    @pytest.mark.parametrize("name,wrapper", [("matmul", kmatmul),
                                              ("flash_attention", kflash)])
    def test_install_routes_the_launch_and_clears_the_handle(
            self, fake_libs, tmp_path, name, wrapper):
        """Which library a launch runs: the kernel wrapper's handle opens
        the built library, then after an install the prebuilt one without
        a build, then after the removal the built one again."""
        wrapper._kernel()
        assert _FakeLibrary.opened[-1] == str(build.library_path(name))
        assert fake_libs == [name]
        prebuilt = tmp_path / f"{name}-prebuilt.so"
        build.install(name, prebuilt)
        wrapper._kernel()
        assert _FakeLibrary.opened[-1] == str(prebuilt)
        assert fake_libs == [name]  # nothing built for the installed one
        build.uninstall(name)
        wrapper._kernel()
        assert _FakeLibrary.opened[-1] == str(build.library_path(name))
        assert len(_FakeLibrary.opened) == 3

    def test_bundle_install_writes_verified_libraries(self, fake_libs,
                                                      tmp_path, monkeypatch):
        """A CUDA bundle's libraries land at content-addressed paths under
        build/ and are installed for their sources; setting the default to
        None removes them. (The bundle is made on the CPU from stand-in
        bytes and built with its load checks, not ``load``, which needs
        the card.)"""
        import base64
        import hashlib

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
        libs = {}
        for n in build.SOURCES:
            blob = f"library {n}".encode()
            libs[n] = {"file": f"{n}.so", "bytes": len(blob),
                       "sha1": hashlib.sha1(blob).hexdigest(),
                       "b64": base64.b64encode(blob).decode()}
        obj = {"backend": "torch-cuda", "libraries": libs, "entries": [],
               "schedules": []}
        from repro_torch.tuna.golden import _verified_libraries

        bundle = KernelBundle(obj, libraries=_verified_libraries("b", obj))
        tuner.set_default_bundle(bundle)
        paths = build.installed()
        assert sorted(paths) == sorted(build.SOURCES)
        for n, p in paths.items():
            assert p.parent == tmp_path / "kernels" / "bundled"
            assert p.name == f"{n}-{libs[n]['sha1']}.so"
            assert p.read_bytes() == f"library {n}".encode()
        kmatmul._kernel()
        assert _FakeLibrary.opened[-1] == str(paths["matmul"])
        tuner.set_default_bundle(None)
        assert build.installed() == {}
        # a library whose bytes do not match their sha1 is refused
        libs["matmul"]["b64"] = base64.b64encode(b"other bytes").decode()
        with pytest.raises(BundleError, match="sha1"):
            _verified_libraries("b", obj)

    def test_nvcc_runs_are_counted(self, tmp_path, monkeypatch):
        class FakeNvcc:
            def __init__(self, argv, **kw):
                out = argv[argv.index("-o") + 1]
                with open(out, "wb") as f:
                    f.write(b"built")
                self.returncode = 0

            def communicate(self):
                return "ptxas info", None

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(build, "NVCC_RUNS", {n: 0 for n in build.SOURCES})
        monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
        build.build(["matmul"])
        build.build(["matmul"])  # built already: no second run
        build.build()
        assert ops.kernel_build_counts() == {"flash_attention": 1, "flash_attention_f16": 1,
                                             "flash_attention_wide": 1,
                                             "flash_attention_chunked": 1, "matmul": 1,
                                             "matmul_f16": 1}
        assert build.library_path("matmul").read_bytes() == b"built"


class TestStaleCacheDegradeClearsMemos:
    def test_env_cache_stale_degrade_clears_memos(self, tmp_path,
                                                  monkeypatch):
        """$REPRO_TUNA_CACHE degrading to OFF must drop the block-pick
        memos, so shapes memoised under an earlier snapshot do not keep
        serving its blocks after the snapshot was rejected. The stored
        pick is a built pair the grid would not pick, (64, 128): the
        reference's test stores (256, 128), which the port's kernel is not
        built for, so its picker would pass it over."""
        db = ScheduleDatabase(tmp_path / "db.jsonl")
        db.add(ScheduleRecord(
            op="flash[d=128,dtype_bytes=2,s=2048]", target=TGT,
            config={"block_q": 64, "block_k": 128}, score=1e-9))
        snap = str(tmp_path / "cache.json")
        ScheduleCache.build(db.path, snap)
        tuner.set_default_cache(snap)
        assert ops.tuned_flash_blocks(2048, 128) == (64, 128)  # memoised

        obj = json.load(open(snap))
        obj["cost_model_version"] = "cm0"
        stale = str(tmp_path / "stale.json")
        json.dump(obj, open(stale, "w"))
        monkeypatch.setenv("REPRO_TUNA_CACHE", stale)
        monkeypatch.setattr(tuner, "_DEFAULT_CACHE", tuner._UNSET)
        with pytest.warns(StaleSnapshotWarning,
                          match="REPRO_TUNA_CACHE disabled"):
            assert tuner.get_default_cache() is None
        assert ops.tuned_flash_blocks(2048, 128) != (64, 128)


class TestPublishRoundtrip:
    def test_golden_and_bundle_ship_over_mem_transport(self, tmp_path):
        src = tmp_path / "src"
        dst = tmp_path / "dst"
        os.makedirs(dst)
        mgr = GoldenManager(str(src))
        info = mgr.promote(mk_records(), TGT)
        _, release = mgr.load_release(info.path)
        binfo = build_kernel_bundle(release, str(src), TGT,
                                    golden_name=info.name, device="cpu")
        t = _mem(tmp_path)
        manifests = mgr.publish(t, info, bundle=binfo)
        assert len(manifests) == 4  # release + pointer, bundle + pointer
        for name in t.list():
            t.pull(name, str(dst / name))
        hdr, records = GoldenManager(str(dst)).load_release(
            str(dst / os.path.basename(info.latest)))
        assert hdr["sha1"] == info.sha1 and len(records) == 3
        bundle = KernelBundle.load(str(dst / os.path.basename(binfo.latest)),
                                   device="cpu")
        assert bundle.sha1 == binfo.sha1 and len(bundle) == 2
        x = torch.ones((128, 128))
        assert bundle.executable("matmul", (x, x)) is not None


class TestServeParity:
    def test_serve_with_bundle_token_identical(self, tmp_path):
        """Reduced yi-6b on the reference's weights: the serve with a CPU
        bundle whose entries match its prefills gives the tokens of the
        serve without one and of the reference's greedy decode."""
        from repro.configs.base import get_config as jget_config
        from repro.launch.engine import greedy_decode_reference as jgreedy
        from repro.models.model import Model as JModel
        from repro_torch.configs.base import get_config
        from repro_torch.launch.engine import Request
        from repro_torch.launch.serve import serve
        from repro_torch.models.model import Model
        from repro_torch.weights import from_jax

        cfg = get_config("yi_6b").reduced()
        plen, max_new, cap = 4, 4, 12
        gqa = op_registry.make_space(
            "flash_gqa", {"s": plen, "d": cfg.head_dim, "hq": cfg.n_heads,
                          "hkv": cfg.n_kv_heads, "causal": True,
                          "dtype_bytes": 4}, "sm90").signature()
        records = mk_records() + [ScheduleRecord(
            op=gqa, target=TGT, score=1e-6,
            config={"block_q": 64, "block_k": 64})]
        mgr = GoldenManager(str(tmp_path))
        info = mgr.promote(records, TGT)
        _, release = mgr.load_release(info.path)
        binfo = build_kernel_bundle(release, str(tmp_path), TGT,
                                    golden_name=info.name, device="cpu")

        jmodel = JModel(jget_config("yi_6b").reduced())
        jparams = jmodel.init(jax.random.key(0))
        model = Model(cfg, device="cpu")
        params = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        rng = np.random.default_rng(11)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, plen)]
                   for _ in range(3)]

        def run():
            reqs = [Request(i, list(p), max_new) for i, p in enumerate(prompts)]
            serve(model, params, reqs, slots=2, cap=cap)
            return [r.out for r in reqs]

        plain = run()
        ops.use_kernel_bundle(binfo.path, device="cpu")
        bundled = run()
        assert ops.get_kernel_bundle().exec_hits == len(prompts) * cfg.n_layers
        assert bundled == plain
        assert plain == [jgreedy(jmodel, jparams, p, max_new, cap)
                         for p in prompts]


    def test_serve_cli_installs_the_bundle_first(self, built_bundle, capsys):
        """``launch/serve.py --kernel-bundle`` installs the bundle before
        the model's first launch and reports its hits and the nvcc runs."""
        from repro_torch.launch import serve

        _, _, binfo = built_bundle
        serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                    "--requests", "2", "--max-new", "3",
                    "--kernel-bundle", binfo.latest])
        out = capsys.readouterr().out
        assert "[serve] kernel bundle: 2 kernel entries / 3 schedules" in out
        assert "bundled kernel hits" in out and "nvcc runs this process" in out
        assert ops.get_kernel_bundle().sha1 == binfo.sha1


class TestGoldenCLI:
    def _write_db(self, path, records):
        db = ScheduleDatabase(path)
        for r in records:
            db.add(r)
        return str(path)

    def test_cli_end_to_end_with_bundle(self, tmp_path, capsys):
        db = self._write_db(tmp_path / "db.jsonl", mk_records())
        gdir = str(tmp_path / "golden")
        assert cli.main(["golden", "--db", db, "--dir", gdir, "--bundle",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "promoted" in out and "first release in this lineage" in out
        assert "2 bundled kernel(s) over 3 schedules" in out
        assert "no bundled kernel for conv2d[foo=1]" in out
        # re-run: content-addressed no-op, still gated against itself
        assert cli.main(["golden", "--db", db, "--dir", gdir]) == 0
        out = capsys.readouterr().out
        assert "up to date" in out and "gated against" in out
        names = os.listdir(gdir)
        assert any(n.startswith(f"golden.{TGT}.") and "latest" not in n
                   for n in names)
        assert any(n.startswith(f"bundle.{TGT}.") and "latest" not in n
                   for n in names)

    def test_cli_refuses_regression_then_waives(self, tmp_path, capsys):
        gdir = str(tmp_path / "golden")
        good = self._write_db(tmp_path / "good.jsonl", mk_records())
        assert cli.main(["golden", "--db", good, "--dir", gdir]) == 0
        capsys.readouterr()
        worse = self._write_db(tmp_path / "worse.jsonl",
                               mk_records(mm_score=5e-6))
        assert cli.main(["golden", "--db", worse, "--dir", gdir]) == 1
        err = capsys.readouterr().err
        assert "REFUSED golden promotion" in err and MM_OP in err
        assert cli.main(["golden", "--db", worse, "--dir", gdir,
                         "--waive", f"{MM_OP}@{TGT}"]) == 0
        err = capsys.readouterr().err
        assert "WAIVED" in err

    def test_cli_publish_over_mem(self, tmp_path, capsys):
        db = self._write_db(tmp_path / "db.jsonl", mk_records())
        t = _mem(tmp_path)
        url = f"mem://{t.bucket}"
        assert cli.main(["golden", "--db", db,
                         "--dir", str(tmp_path / "g"),
                         "--publish", url]) == 0
        assert "published" in capsys.readouterr().out
        assert any(n.startswith("golden.") for n in t.list())

    def test_cli_no_records_is_an_error(self, tmp_path, capsys):
        db = str(tmp_path / "empty.jsonl")
        ScheduleDatabase(db)
        assert cli.main(["golden", "--db", db,
                         "--dir", str(tmp_path / "g")]) == 2
        assert "no records" in capsys.readouterr().err

    def test_cli_default_dir_is_under_build(self):
        args = cli.build_parser().parse_args(["golden", "--db", "x.jsonl"])
        assert args.dir == os.path.join("build", "golden")
        assert args.device == "cuda" and args.target == TGT


class TestCompactExportGuards:
    def _base_with_shards(self, tmp_path):
        from repro_torch.tuna.fleet import shard_store_path

        base = str(tmp_path / "db.jsonl")
        db = ScheduleDatabase(base)
        db.add(mk_records()[0])
        shard = ScheduleDatabase(shard_store_path(base, 0))
        shard.add(mk_records(fl_score=7e-7)[1])
        return base, shard.path

    def test_compact_refuses_stale_partial_store(self, tmp_path, capsys):
        """compact must not rewrite the base store while fleet shards sit
        next to it."""
        base, _ = self._base_with_shards(tmp_path)
        assert cli.main(["compact", "--db", base]) == 2
        err = capsys.readouterr().err
        assert "per-shard store" in err and "sync" in err
        assert cli.main(["compact", "--db", base, "--ignore-shards"]) == 0

    def test_export_refuses_stale_partial_store(self, tmp_path, capsys):
        base, _ = self._base_with_shards(tmp_path)
        out = str(tmp_path / "best.json")
        assert cli.main(["export", "--db", base, "--out", out]) == 2
        assert not os.path.exists(out)
        assert cli.main(["export", "--db", base, "--out", out,
                         "--ignore-shards"]) == 0
        assert len(json.load(open(out))) == 1  # base store only, by choice

    def test_compact_with_transport_pulls_merges_pushes(self, tmp_path,
                                                        capsys):
        from repro_torch.tuna.fleet import shard_store_path

        t = _mem(tmp_path)
        url = f"mem://{t.bucket}"
        # the fleet published two shard stores on the channel
        pub = tmp_path / "pub"
        os.makedirs(pub)
        for i, rec in enumerate(mk_records(with_conv=False)):
            p = shard_store_path(str(pub / "db.jsonl"), i)
            ScheduleDatabase(p).add(rec)
            t.push(p, os.path.basename(p))
        work = tmp_path / "work"
        os.makedirs(work)
        base = str(work / "db.jsonl")
        assert cli.main(["compact", "--db", base, "--transport", url,
                         "--num-shards", "2"]) == 0
        out = capsys.readouterr().out
        assert out.count("pulled") == 2 and "compacted" in out
        assert len(ScheduleDatabase(base)) == 2  # both shards absorbed
        # and the merged store went back on the channel under its base name
        assert "db.jsonl" in t.list()

    def test_transport_without_num_shards_fails_fast(self, tmp_path,
                                                     capsys):
        t = _mem(tmp_path)
        rc = cli.main(["export", "--db", str(tmp_path / "db.jsonl"),
                       "--out", str(tmp_path / "o.json"),
                       "--transport", f"mem://{t.bucket}"])
        assert rc == 2
        assert "--num-shards" in capsys.readouterr().err

    def test_export_with_transport_covers_the_fleet(self, tmp_path, capsys):
        from repro_torch.tuna.fleet import shard_store_path

        t = _mem(tmp_path)
        pub = tmp_path / "pub"
        os.makedirs(pub)
        p = shard_store_path(str(pub / "db.jsonl"), 0)
        ScheduleDatabase(p).add(mk_records()[0])
        t.push(p, os.path.basename(p))
        work = tmp_path / "work"
        os.makedirs(work)
        out = str(work / "best.json")
        assert cli.main(["export", "--db", str(work / "db.jsonl"),
                         "--out", out, "--transport", f"mem://{t.bucket}",
                         "--num-shards", "2"]) == 0
        err = capsys.readouterr().err
        assert "not published yet" in err  # shard 1 missing -> loud warning
        assert len(json.load(open(out))) == 1


class TestAgainstTheReference:
    def test_each_package_reads_the_others_release(self, tmp_path):
        port = GoldenManager(str(tmp_path / "port"))
        ref = jgolden.GoldenManager(str(tmp_path / "ref"))
        pinfo = port.promote(mk_records(), TGT, source="port")
        rinfo = ref.promote(mk_records(cls=JRecord), TGT, source="ref")
        assert pinfo.name == rinfo.name and pinfo.sha1 == rinfo.sha1
        rhdr, rrecs = jgolden.GoldenManager(str(tmp_path)).load_release(
            pinfo.latest)
        phdr, precs = GoldenManager(str(tmp_path)).load_release(rinfo.latest)
        assert rhdr["sha1"] == phdr["sha1"] == pinfo.sha1
        assert [dataclasses.asdict(r) for r in rrecs] == \
            [dataclasses.asdict(r) for r in precs]
        # each gates against the other's predecessor, with the same result
        with pytest.raises(GoldenRegressionError) as pe:
            GoldenManager(str(tmp_path / "ref")).promote(
                mk_records(mm_score=5e-6, with_flash=False), TGT)
        with pytest.raises(jgolden.GoldenRegressionError) as re_:
            jgolden.GoldenManager(str(tmp_path / "port")).promote(
                mk_records(mm_score=5e-6, with_flash=False, cls=JRecord),
                TGT)
        key = lambda regs: sorted((r.op, r.kind, r.old_score, r.new_score)
                                  for r in regs)
        assert key(pe.value.regressions) == key(re_.value.regressions)
        assert len(pe.value.regressions) == 2
        # and a waived promotion by one is the other's predecessor
        spec = [f"{MM_OP}@{TGT}"]
        w = GoldenManager(str(tmp_path / "ref")).promote(
            mk_records(mm_score=5e-6), TGT, waive=spec)
        nxt = jgolden.GoldenManager(str(tmp_path / "ref")).promote(
            mk_records(mm_score=4e-6, cls=JRecord), TGT)
        assert nxt.predecessor == w.name and nxt.gated_against == 3

    def test_each_package_refuses_the_others_bundle(self, tmp_path):
        mm = [r for r in mk_records() if r.op == MM_OP]
        pinfo = build_kernel_bundle(mm, str(tmp_path / "port"), TGT,
                                    device="cpu")
        with pytest.raises(jgolden.BundleError, match="backend"):
            jgolden.KernelBundle.load(pinfo.path)
        rinfo = jgolden.build_kernel_bundle(
            [r for r in mk_records(cls=JRecord) if r.op == MM_OP],
            str(tmp_path / "ref"), TGT)
        for device in ("cpu", "cuda"):
            with pytest.raises(BundleError, match="backend"):
                KernelBundle.load(rinfo.path, device=device)
