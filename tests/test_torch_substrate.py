"""The port's training substrate held against the reference's on the CPU:
the train step (AdamW in each state dtype, gradient accumulation, int8
gradient compression), the LR schedule, the port's copies of
tests/test_substrate.py (``TestAdamW``, ``TestData``, ``TestCheckpoint``,
``TestFaultTolerance``, ``TestStraggler``) and of
tests/test_system.py::TestTrainEndToEnd's training tests, checkpoints read
across the two packages, and a resume that is bit-exact.

Tolerances (f32 on both sides unless said): parameters, moments and
metrics after train steps within ``TOL`` (1e-4 absolute and relative, as
the forward parity of test_torch_models.py), and for the int8 state the
parameters within ``lr`` absolute and the quantised moments within one
level: an int8 moment whose f32 value lies within rounding of a
quantisation boundary may take the neighbouring level on one side, which
moves that element's next update by up to about one learning rate.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import MemmapTokens, SyntheticConfig, SyntheticTokens
from repro_torch.launch import steps
from repro_torch.launch.train import TrainOptions, train, train_with_recovery
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.runtime.failure import FailureInjector, InjectedFailure, RestartPolicy
from repro_torch.runtime.straggler import Heartbeat, StragglerMonitor
from repro_torch.weights import from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src"
RNG = np.random.default_rng(0)


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


def _bits(x) -> np.ndarray:
    """A tensor's or array's values, bf16 as its 16-bit patterns."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JModel(jget_config(arch).reduced()).init(jax.random.key(0))


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

# reduced yi-6b with d_ff 512, so that w1 and w3 ([2, 64, 512], 65536
# elements, last axis a multiple of 128) take int8 moments
WIDE = dict(d_ff=512)
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _wide_jparams():
    jcfg = dataclasses.replace(jget_config("yi_6b").reduced(), **WIDE)
    return JModel(jcfg).init(jax.random.key(0))


def _train_pair(state_dtype, **step_kw):
    jcfg = dataclasses.replace(jget_config("yi_6b").reduced(), **WIDE)
    cfg = dataclasses.replace(get_config("yi_6b").reduced(), **WIDE)
    jopt = jadamw.AdamWConfig(lr=LR, state_dtype=state_dtype)
    opt = adamw.AdamWConfig(lr=LR, state_dtype=state_dtype)
    jp = _wide_jparams()
    jstep = jax.jit(jsteps.make_train_step(JModel(jcfg), jopt, **step_kw))
    step = steps.make_train_step(Model(cfg, device="cpu"), opt, **step_kw)
    params = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return ((jstep, jp, jadamw.init_state(jopt, jp)),
            (step, params, adamw.init_state(opt, params)))


def _close_trees(got, want, atol, rtol=1e-4):
    for path, a, b in zip(tree.paths(got), tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype)), path
        if a.dtype == torch.int8:  # a quantised moment: at most one level apart
            assert np.abs(a.numpy().astype(np.int32) - b.astype(np.int32)).max() <= 1, path
            continue
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), atol=atol,
                                   rtol=rtol, err_msg=path)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_two_train_steps_match_reference(state_dtype):
    """Parameters, moments and metrics after one and two steps."""
    (jstep, jp, jstate), (step, params, state) = _train_pair(state_dtype)
    atol = LR if state_dtype == "int8" else TOL["atol"]
    for i in range(2):
        cfg = get_config("yi_6b").reduced()
        batch = _batch(cfg, seed=10 + i, b=4)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        assert set(m) == set(jm)
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL)
        _close_trees(params, jp, atol)
        _close_trees({"m": state["m"], "v": state["v"]},
                     {"m": jstate["m"], "v": jstate["v"]}, atol=TOL["atol"], rtol=1e-3)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
    if state_dtype == "int8":
        assert isinstance(state["m"]["layers"][0]["mlp"]["w1"], dict)
        assert state["m"]["layers"][0]["mlp"]["w2"].dtype == torch.bfloat16


def test_accumulated_step_matches_reference_and_one_large_batch():
    """accum_steps=2 against the reference's accum_steps=2, and against the
    port's own step on the whole batch at once."""
    (jstep, jp, jstate), (step, params, state) = _train_pair("float32", accum_steps=2)
    batch = _batch(get_config("yi_6b").reduced(), seed=20, b=4)
    jp, _, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params, _, m = step(params, state, batch)
    _close_trees(params, jp, TOL["atol"])
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **TOL)
    (_, _, _), (step1, params1, state1) = _train_pair("float32")
    params1, _, m1 = step1(params1, state1, batch)
    np.testing.assert_allclose(float(m1["ce"]), float(m["ce"]), rtol=1e-5)
    for a, b in zip(tree.leaves(params1), tree.leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_int8_grad_compression_matches_reference():
    (jstep, jp, jstate), (step, params, state) = _train_pair(
        "float32", grad_compression="int8")
    batch = _batch(get_config("yi_6b").reduced(), seed=30, b=2)
    jp, _, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params, _, m = step(params, state, batch)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), **TOL)
    _close_trees(params, jp, LR)


def test_int8_round_trip_matches_reference_and_keeps_small_leaves_exact():
    from repro.parallel import collectives as jcoll
    from repro_torch.parallel import collectives

    rng = np.random.default_rng(4)
    grads = {"w": rng.standard_normal((3, 4, 256)).astype(np.float32),
             "b": rng.standard_normal((100,)).astype(np.float32)}
    want = jcoll.int8_compress_decompress(jax.tree.map(jnp.asarray, grads))
    got = collectives.int8_compress_decompress(tree.map(torch.from_numpy, grads))
    np.testing.assert_array_equal(got["b"].numpy(), grads["b"])
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6, atol=1e-7)


def test_sliced_update_equals_whole_leaf(monkeypatch):
    """Walking a leaf along axis 0 in slices (``SLICE_ELEMS``) gives the
    same parameters and int8 moments, to the bit, as one slice per leaf."""
    rng = np.random.default_rng(6)
    p0 = {"w": torch.from_numpy(rng.standard_normal((6, 4, 256)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((6, 4, 256)).astype(np.float32))}
    # no clipping: the global norm sums its slices in another order
    cfg = adamw.AdamWConfig(lr=1e-2, state_dtype="int8", grad_clip=1e9)
    outs = []
    for elems in (2**26, 1024):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", elems)
        params = tree.map(torch.clone, p0)
        state = adamw.init_state(cfg, params)
        state["m"]["w"] = adamw.quantize_i8(torch.full((6, 4, 256), 0.1))
        state["v"]["w"] = adamw.quantize_i8(torch.full((6, 4, 256), 0.2))
        for _ in range(2):
            params, state, _ = adamw.apply_updates(cfg, params, g, state)
        outs.append((params["w"], state["m"]["w"]["q"], state["m"]["w"]["scale"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_schedule_matches_reference():
    from repro.optim.schedule import warmup_cosine as jwc
    from repro_torch.optim.schedule import warmup_cosine

    for s in (0, 1, 50, 100, 101, 5000, 10_000, 20_000):
        np.testing.assert_allclose(float(warmup_cosine(torch.tensor(s, dtype=torch.int32))),
                                   float(jwc(jnp.asarray(s, jnp.int32))), rtol=1e-6)
        assert float(warmup_cosine(s)) == pytest.approx(float(jwc(s)), rel=1e-6)


def test_prefill_and_serve_steps_wrap_the_model():
    cfg = get_config("yi_6b").reduced()
    model = Model(cfg, device="cpu")
    params = from_jax(jax.tree.map(np.asarray, _jparams("yi_6b")), device="cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :8])
    cache, pos, last = steps.make_prefill_step(model, 12)(params, {"tokens": toks})
    _, _, want = model.prefill(params, {"tokens": toks}, 12)
    torch.testing.assert_close(last, want, rtol=0, atol=0)
    logits, _ = steps.make_serve_step(model)(params, cache, toks[:, -1], pos)
    assert logits.shape == (2, cfg.vocab)


def test_step_options_waiting_for_a_mesh_raise():
    """``grad_shardings`` waited for a mesh and raised until the multi-device
    slice; now it is taken, and a meshless step (whose leaves are plain
    tensors) leaves it unused: two accumulated steps with it are bit-equal
    to two without."""
    cfg = get_config("yi_6b").reduced()
    model = Model(cfg, device="cpu")
    opt = adamw.AdamWConfig()
    runs = []
    for kw in ({}, {"grad_shardings": {}}):
        step = steps.make_train_step(model, opt, accum_steps=2, **kw)
        params = from_jax(jax.tree.map(np.asarray, _jparams("yi_6b")), device="cpu")
        state = adamw.init_state(opt, params)
        for seed in (0, 1):
            params, state, _ = step(params, state, _batch(cfg, seed, b=4))
        runs.append(tree.leaves((params, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# --------------------------------------------------------------------------
# the port's copies of tests/test_substrate.py
# --------------------------------------------------------------------------


class TestAdamW:
    def _params(self):
        return {"w": torch.from_numpy(RNG.standard_normal((4, 256)).astype(np.float32)),
                "b": torch.zeros((256,))}

    def test_matches_reference_math(self):
        cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=1e9)
        params = self._params()
        w0 = params["w"].clone()
        grads = tree.map(lambda p: torch.ones_like(p) * 0.1, params)
        state = adamw.init_state(cfg, params)
        new_params, state, _ = adamw.apply_updates(cfg, params, grads, state)
        # first step: m_hat = g, v_hat = g^2 -> update = g/(|g|+eps) = 1
        want = w0 - 1e-2 * 0.1 / (0.1 + cfg.eps)
        np.testing.assert_allclose(new_params["w"].numpy(), want.numpy(), rtol=1e-5)

    def test_grad_clip_global_norm(self):
        cfg = adamw.AdamWConfig(lr=0.0, grad_clip=1.0)
        params = self._params()
        grads = tree.map(lambda p: torch.ones_like(p) * 100.0, params)
        _, _, metrics = adamw.apply_updates(cfg, params, grads,
                                            adamw.init_state(cfg, params))
        assert float(metrics["grad_norm"]) > 1.0  # reported pre-clip

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_low_precision_states_still_converge(self, dtype):
        cfg = adamw.AdamWConfig(lr=0.05, state_dtype=dtype, weight_decay=0.0)
        w = torch.from_numpy(RNG.standard_normal((8, 128)).astype(np.float32))
        params = {"w": w}
        state = adamw.init_state(cfg, params)
        for _ in range(60):
            grads = {"w": params["w"].clone()}  # target 0
            params, state, _ = adamw.apply_updates(cfg, params, grads, state)
        assert float(params["w"].abs().mean()) < 0.2

    def test_int8_roundtrip_error_bounded(self):
        x = torch.from_numpy((RNG.standard_normal((4, 512)) * 3.0).astype(np.float32))
        back = adamw.dequantize_i8(adamw.quantize_i8(x))
        # blockwise absmax scaling: error <= scale/2 = absmax/254 per block
        blocks = x.numpy().reshape(4, -1, 128)
        bound = np.abs(blocks).max(-1, keepdims=True) / 254 + 1e-6
        err = np.abs(back.numpy().reshape(4, -1, 128) - blocks)
        assert (err <= bound).all()

    def test_quantize_matches_reference_bit_for_bit(self):
        x = (RNG.standard_normal((3, 2, 384)) * 2.0).astype(np.float32)
        want = jadamw.quantize_i8(jnp.asarray(x))
        got = adamw.quantize_i8(torch.from_numpy(x))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
        np.testing.assert_array_equal(adamw.dequantize_i8(got).numpy(),
                                      np.asarray(jadamw.dequantize_i8(want)))

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
    def test_state_layout_matches_reference(self, state_dtype):
        """Which leaves take int8 (at least 65536 elements, last axis a
        multiple of 128), bf16 or f32 moments, and their shapes."""
        shapes = {"big": (4, 128, 128), "odd": (512, 129), "small": (4, 128), "vec": (256,)}
        jp = {k: jnp.zeros(s) for k, s in shapes.items()}
        want = jadamw.init_state(jadamw.AdamWConfig(state_dtype=state_dtype), jp)
        got = adamw.init_state(adamw.AdamWConfig(state_dtype=state_dtype),
                               {k: torch.zeros(s) for k, s in shapes.items()})
        assert tree.paths(got) == [jax.tree_util.keystr(p) for p, _ in
                                   jax.tree_util.tree_flatten_with_path(want)[0]]
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))


class TestData:
    def test_deterministic_and_restartable(self):
        cfg = SyntheticConfig(vocab=1000, seq_len=32, global_batch=8)
        a = SyntheticTokens(cfg).batch(7)
        b = SyntheticTokens(cfg).batch(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_shards_disjoint_and_cover(self):
        cfg = SyntheticConfig(vocab=50000, seq_len=16, global_batch=8)
        whole = SyntheticTokens(cfg).batch(3)["tokens"]
        parts = [SyntheticTokens(cfg, shard=i, num_shards=4).batch(3)["tokens"]
                 for i in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts, 0), whole)

    def test_labels_are_next_tokens(self):
        cfg = SyntheticConfig(vocab=1000, seq_len=32, global_batch=2)
        b = SyntheticTokens(cfg).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_prefetch_loader_ordered(self):
        cfg = SyntheticConfig(vocab=100, seq_len=8, global_batch=2)
        src = SyntheticTokens(cfg)
        loader = PrefetchLoader(src, start_step=5)
        try:
            for want in (5, 6, 7):
                step, batch = loader.get(want)
                assert step == want
                np.testing.assert_array_equal(batch["tokens"], src.batch(want)["tokens"])
        finally:
            loader.close()

    def test_batches_equal_the_references(self, tmp_path):
        from repro.data.synthetic import MemmapTokens as JMemmap
        from repro.data.synthetic import SyntheticConfig as JConfig
        from repro.data.synthetic import SyntheticTokens as JTokens

        for shard in range(2):
            got = SyntheticTokens(SyntheticConfig(64000, 33, 4, seed=3), shard, 2).batch(9)
            want = JTokens(JConfig(64000, 33, 4, seed=3), shard, 2).batch(9)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(got[key], want[key])
        path = tmp_path / "tokens.bin"
        np.arange(1000, dtype=np.int32).tofile(path)
        for step in (0, 3, 11):
            got, want = MemmapTokens(str(path), 7, 4).batch(step), JMemmap(str(path), 7, 4).batch(step)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])


class TestCheckpoint:
    def test_save_restore_bit_exact(self, tmp_path):
        t = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
        store.save(str(tmp_path), 5, t)
        like = tree.map(torch.zeros_like, t)
        got, manifest = store.restore(str(tmp_path), like)
        assert manifest["step"] == 5
        for x, y in zip(tree.leaves(t), tree.leaves(got)):
            assert x.dtype == y.dtype and torch.equal(x, y)

    def test_latest_pointer_and_gc(self, tmp_path):
        t = {"a": torch.ones((2,))}
        for s in (1, 2, 3, 4):
            store.save(str(tmp_path), s, t)
        store.gc_old(str(tmp_path), keep=2)
        assert store.latest_step(str(tmp_path)) == 4
        kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
        assert len(kept) == 2

    def test_async_checkpointer(self, tmp_path):
        ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
        ck.save(1, {"a": torch.ones((4,))})
        ck.wait()
        assert store.latest_step(str(tmp_path)) == 1

    def test_async_checkpointer_reraises_a_failed_write(self, tmp_path):
        target = tmp_path / "file"
        target.write_text("not a directory")
        ck = store.AsyncCheckpointer(str(target))
        ck.save(1, {"a": torch.ones((4,))})
        with pytest.raises(OSError):
            ck.wait()

    def test_layout_and_manifest_match_reference(self, tmp_path):
        """The same tree written by both packages: the same files, leaf paths,
        treedef text, shapes and dtypes, and the same bytes per leaf."""
        arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "layers": ({"k": np.ones((2, 2), np.float32)},
                             {"k": np.full((2,), 2, np.int32)}),
                  "a": np.int32(7)}
        jtree = jax.tree.map(jnp.asarray, arrays)
        ttree = tree.map(torch.as_tensor, arrays)
        jstore.save(str(tmp_path / "ref"), 3, jtree)
        store.save(str(tmp_path / "port"), 3, ttree)
        sub = "step_00000003"
        assert sorted(os.listdir(tmp_path / "ref" / sub)) == sorted(
            os.listdir(tmp_path / "port" / sub))
        import json

        mans = [json.loads((tmp_path / d / sub / "manifest.json").read_text())
                for d in ("ref", "port")]
        for key in ("step", "treedef", "paths", "leaves", "meta"):
            assert mans[0][key] == mans[1][key], key
        for name in os.listdir(tmp_path / "ref" / sub):
            if name.endswith(".npy"):
                assert ((tmp_path / "ref" / sub / name).read_bytes()
                        == (tmp_path / "port" / sub / name).read_bytes()), name

    @pytest.mark.parametrize("state_dtype", ["float32", "int8"])
    def test_cross_read_both_ways(self, tmp_path, state_dtype):
        """(params, opt_state) of an f32 model after one train step, written
        by each package and restored by the other, bit for bit."""
        (jstep, jp, jstate), (step, params, state) = _train_pair(state_dtype)
        batch = _batch(get_config("yi_6b").reduced(), seed=40, b=2)
        jp, jstate, _ = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, _ = step(params, state, batch)
        jstore.save(str(tmp_path / "ref"), 1, (jp, jstate))
        store.save(str(tmp_path / "port"), 1, (params, state))
        got, _ = store.restore(str(tmp_path / "ref"), (params, state))
        for a, b in zip(tree.leaves(got), jax.tree.leaves((jp, jstate))):
            assert str(a.dtype).endswith(str(np.asarray(b).dtype))
            np.testing.assert_array_equal(_bits(a), _bits(b))
        # the reference reads numpy's '<V2' bf16 leaves back as raw void arrays
        back, _ = jstore.restore(str(tmp_path / "port"), (jp, jstate))
        for a, b in zip(jax.tree.leaves(back), tree.leaves((params, state))):
            a = np.asarray(a)
            a = a.view(np.int16) if a.dtype.kind == "V" else a
            np.testing.assert_array_equal(a, _bits(b))

    def test_bf16_round_trip_without_ml_dtypes(self, tmp_path):
        """A bf16 tree restores bit for bit in a process that cannot import
        ``ml_dtypes`` (the card's machine has no jax), and the port reads
        the reference's bf16 leaves (numpy's '<V2' arrays) as bf16."""
        code = (
            "import sys; sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from repro_torch.checkpoint import store\n"
            "g = torch.Generator().manual_seed(0)\n"
            "x = torch.randn((3, 5, 7), generator=g).to(torch.bfloat16)\n"
            "x[0, 0, :3] = torch.tensor([float('nan'), float('inf'), -0.0])\n"
            "t = {'w': x, 'n': {'s': torch.tensor(3, dtype=torch.int32)}}\n"
            f"store.save({str(tmp_path)!r}, 2, t)\n"
            "got, m = store.restore("
            f"{str(tmp_path)!r}, {{'w': torch.zeros(1), 'n': {{'s': torch.zeros(1)}}}})\n"
            "assert got['w'].dtype == torch.bfloat16, got['w'].dtype\n"
            "assert torch.equal(got['w'].view(torch.int16), x.view(torch.int16))\n"
            "assert m['leaves'][1]['dtype'] == 'bfloat16', m['leaves']\n"
            "assert 'ml_dtypes' not in [k for k, v in sys.modules.items() if v]\n"
        )
        env = dict(os.environ, PYTHONPATH=str(SRC))
        res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        jx = jnp.asarray(RNG.standard_normal((4, 6)), jnp.bfloat16)
        jstore.save(str(tmp_path / "ref"), 1, {"w": jx})
        got, _ = store.restore(str(tmp_path / "ref"), {"w": torch.zeros(1)})
        assert got["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                      np.asarray(jx).view(np.int16))


def _train_opts(tmp_path, steps=12, **kw):
    return TrainOptions(steps=steps, batch=2, seq=16, ckpt_dir=str(tmp_path),
                        ckpt_every=4, log_every=100, device="cpu", **kw)


def _assert_same_state(a, b):
    for x, y in zip(tree.leaves((a["params"], a["opt_state"])),
                    tree.leaves((b["params"], b["opt_state"]))):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestFaultTolerance:
    def test_restart_resumes_bit_exact(self, tmp_path):
        cfg = get_config("yi_6b").reduced()
        ref = train(cfg, TrainOptions(steps=12, batch=2, seq=16, log_every=100,
                                      device="cpu"))
        # interrupted at step 6 (after the step-4 checkpoint), recovered
        inj = FailureInjector(fail_at_steps={6})
        out = train_with_recovery(cfg, _train_opts(tmp_path), injector=inj)
        assert out["final_step"] == 12
        _assert_same_state(ref, out)

    def test_gives_up_after_max_restarts(self, tmp_path):
        cfg = get_config("yi_6b").reduced()

        class AlwaysFail(FailureInjector):
            def maybe_fail(self, step, phase="step"):
                if phase == "step" and step >= 1:
                    raise InjectedFailure(f"boom {step}")

        policy = RestartPolicy(max_restarts=2)
        with pytest.raises(InjectedFailure):
            train_with_recovery(cfg, _train_opts(tmp_path), injector=AlwaysFail(),
                                policy=policy)
        assert policy.restarts == 2

    def test_crash_during_save_leaves_valid_checkpoint(self, tmp_path):
        cfg = get_config("yi_6b").reduced()
        inj = FailureInjector(fail_during_save_at={8})
        out = train_with_recovery(cfg, _train_opts(tmp_path), injector=inj)
        assert out["final_step"] == 12
        assert store.latest_step(str(tmp_path)) == 12

    def test_resume_with_int8_state_accumulation_and_compression_is_bit_exact(self, tmp_path):
        """The card's resume gate at reduced width: int8 moments,
        accum_steps=2, int8 gradient compression, a checkpoint every 2
        steps and a failure at step 3, against an uninterrupted run."""
        cfg = dataclasses.replace(get_config("yi_6b").reduced(), d_ff=512)
        kw = dict(state_dtype="int8", accum_steps=2, grad_compression="int8")
        ref = train(cfg, TrainOptions(steps=4, batch=4, seq=16, log_every=100,
                                      device="cpu", **kw))
        out = train_with_recovery(
            cfg, TrainOptions(steps=4, batch=4, seq=16, ckpt_dir=str(tmp_path),
                              ckpt_every=2, log_every=100, device="cpu", **kw),
            injector=FailureInjector(fail_at_steps={3}))
        assert out["final_step"] == 4
        assert isinstance(out["opt_state"]["m"]["layers"][0]["mlp"]["w1"], dict)
        _assert_same_state(ref, out)

    def test_heartbeat_and_history(self, tmp_path):
        cfg = get_config("yi_6b").reduced()
        out = train(cfg, TrainOptions(steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path),
                                      ckpt_every=2, log_every=2, device="cpu"))
        assert [h[0] for h in out["history"]] == [2, 4]
        assert (tmp_path / "HEARTBEAT").read_text().split()[0] == "3"
        assert store.latest_step(str(tmp_path)) == 4


class TestStraggler:
    def test_flags_slow_step_and_mitigation(self):
        mon = StragglerMonitor(threshold=2.0, min_seconds=0.0, persistent_after=2)
        for i in range(8):
            assert mon.record(i, 0.10) is None
        ev = mon.record(8, 0.50)
        assert ev is not None and ev.mitigation == "transient"
        ev2 = mon.record(9, 0.50, fetch_seconds=0.4)
        assert ev2.mitigation == "rebalance_data"
        ev3 = mon.record(10, 0.60)
        assert ev3.mitigation == "exclude_and_remesh"


# --------------------------------------------------------------------------
# the port's copies of tests/test_system.py::TestTrainEndToEnd
# --------------------------------------------------------------------------


def _yi_state(opt_cfg):
    model = Model(get_config("yi_6b").reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return model, params, adamw.init_state(opt_cfg, params)


class TestTrainEndToEnd:
    def test_loss_decreases_on_learnable_data(self):
        """Train on a fixed repeating sequence: CE must fall well below the
        ln(V) random floor within 60 steps."""
        opt_cfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
        model, params, state = _yi_state(opt_cfg)
        base = np.arange(33, dtype=np.int32) % model.cfg.vocab
        toks = np.tile(base[None], (4, 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = steps.make_train_step(model, opt_cfg)
        first = None
        for _ in range(60):
            params, state, metrics = step(params, state, batch)
            if first is None:
                first = float(metrics["ce"])
        last = float(metrics["ce"])
        assert last < first * 0.5
        assert last < 2.0  # far below ln(256) = 5.55

    def test_grad_accum_equivalent_to_large_batch(self):
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        model, params, state = _yi_state(opt_cfg)
        batch = _batch(model.cfg, seed=0, b=8)
        p1, _, m1 = steps.make_train_step(model, opt_cfg)(
            tree.map(torch.clone, params), adamw.init_state(opt_cfg, params), batch)
        p4, _, m4 = steps.make_train_step(model, opt_cfg, accum_steps=4)(
            params, state, batch)
        assert float(m1["ce"]) == pytest.approx(float(m4["ce"]), rel=1e-4)
        for a, b in zip(tree.leaves(p1), tree.leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)

    def test_int8_grad_compression_trains(self):
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        model, params, state = _yi_state(opt_cfg)
        step = steps.make_train_step(model, opt_cfg, grad_compression="int8")
        params, state, metrics = step(params, state, _batch(model.cfg, seed=0))
        assert np.isfinite(float(metrics["loss"]))
