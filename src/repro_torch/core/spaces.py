"""Transformation candidate spaces T_e (paper Eq. 1) + TIR instantiation.

The port's own copy of ``repro.core.spaces``, held against it by
``tests/test_torch_core.py``.

A ``Space`` defines the discrete schedule knobs for one tensor operator and
materialises a chosen configuration into (Program TIR, ScheduleMeta). ES
operates on a continuous θ that ``decode`` buckets into knob choices.

This module registers the paper's four §V.B operator families with the
declarative registry in :mod:`repro.core.op_registry` — each is one
:class:`~repro.core.op_registry.OpDef` (attrs, knob generator, TIR builder,
presets) — and keeps the historical ``Space`` subclasses as thin constructor
shims over those defs:

  * ``MatmulSpace``      — C[M,N] += A[M,K]·B[K,N]; TPU: Pallas-style grid
    (block loops + MXU tensor nest + double buffering); CPU/GPU: cache tiling
    + vectorised j + unrolled i (the paper's conv2d/dense CPU schedule
    family); ``sm90`` (the port's tensor-core Hopper kind): the TPU's grid
    form over exactly the tiles ``kernels/csrc/matmul.cu`` is built for.
  * ``BatchMatmulSpace`` — adds a batch grid dimension.
  * ``Conv2dSpace``      — direct NHWC conv, tiled over (oc, oh·ow), reduction
    over (kh, kw, ic); CPU + TPU (im2col-style MXU mapping).
  * ``DepthwiseConv2dSpace`` — per-channel conv (VPU-only on TPU).

The attention families of the reference's model zoo are in ``core.zoo``.
Signatures of the four legacy families are byte-identical to the
pre-registry format.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.cost_model import ScheduleMeta
from repro_torch.core.op_registry import (
    DTYPE_BY_BYTES,
    AttrSpec,
    BundleSkip,
    BundleSpec,
    KnobFeature,
    OpDef,
    Preset,
    RegistrySpace,
    Space,
    register,
)
from repro_torch.core.tir import Access, Compute, LinExpr, Loop, Program, TensorDecl

__all__ = [
    "Space",
    "MatmulSpace",
    "BatchMatmulSpace",
    "Conv2dSpace",
    "DepthwiseConv2dSpace",
]


def _pow2_choices(lo: int, hi: int, cap: int) -> List[int]:
    out = []
    v = lo
    while v <= min(hi, cap):
        out.append(v)
        v *= 2
    return out or [min(lo, cap)]


def _divisors_pow2(n: int, lo: int, hi: int) -> List[int]:
    return [d for d in _pow2_choices(lo, hi, n) if n % d == 0] or [n]


def _wrap_parallel(prog: Program, meta: ScheduleMeta,
                   dims: Sequence[Tuple[str, int]],
                   name: str) -> Tuple[Program, ScheduleMeta]:
    """Wrap a program in outer parallel grid loops (batch / expert / head):
    every tensor gains the leading dims, every access the matching indices."""

    def _idx(acc: Access) -> Access:
        lead = tuple(LinExpr.var(v) for v, _ in dims)
        return Access(acc.tensor, lead + acc.indices, acc.is_store)

    def _add(node):
        if isinstance(node, Loop):
            return dataclasses.replace(
                node, body=tuple(_add(ch) for ch in node.body))
        return dataclasses.replace(
            node, output=_idx(node.output),
            inputs=tuple(_idx(a) for a in node.inputs))

    extents = tuple(e for _, e in dims)
    tensors = tuple(TensorDecl(t.name, extents + t.shape, t.dtype_bytes)
                    for t in prog.tensors)

    def _nest(root):
        body = (_add(root),)
        for var, extent in reversed(dims):
            body = (Loop(var, extent, body, "parallel"),)
        return body[0]

    total = 1
    for e in extents:
        total *= e
    wrapped = Program(tensors, tuple(_nest(r) for r in prog.roots), name=name)
    meta = dataclasses.replace(
        meta,
        grid_size=meta.grid_size * total,
        parallel_extent=meta.parallel_extent * total,
    )
    return wrapped, meta


# ---------------------------------------------------------------------------
# Matmul family
# ---------------------------------------------------------------------------


# Tile sizes the Hopper matmul kernel (kernels/csrc/matmul.cu) is built for:
# consecutive powers of two, so ``_divisors_pow2`` over each range yields
# exactly the built sizes that divide the shape (plus its fallback, dropped
# below when it is not built). bm is one or two wgmma warpgroups of 64 rows;
# bn and bk are whole 64-column (128-byte) swizzle atoms. The kernel also
# runs a tile that does not divide its dimension (a ragged last tile).
SM90_MATMUL_TILES: Dict[str, Tuple[int, ...]] = {
    "bm": (64, 128),
    "bn": (64, 128, 256),
    "bk": (64, 128),
}


def sm90_matmul_smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int) -> int:
    """Shared memory one stage of the Hopper matmul kernel holds: an A tile
    [bm, bk] and a B tile [bk, bn], unpadded. The C tile stays in the
    consumers' registers and is not staged."""
    return (bm * bk + bk * bn) * dtype_bytes


def _built_tiles(n: int, built: Tuple[int, ...]) -> List[int]:
    """The built tiles that divide ``n``; where none does, every built tile
    up to the first that covers ``n`` (all of them where none covers it),
    each run with a ragged last tile."""
    divisors = [d for d in _divisors_pow2(n, built[0], built[-1]) if d in built]
    if divisors:
        return divisors
    covers = [i for i, t in enumerate(built) if t >= n]
    return list(built[:covers[0] + 1] if covers else built)


def _matmul_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    M, N, K = attrs["M"], attrs["N"], attrs["K"]
    if kind == "sm90":
        return {
            "bm": _built_tiles(M, SM90_MATMUL_TILES["bm"]),
            "bn": _built_tiles(N, SM90_MATMUL_TILES["bn"]),
            "bk": _built_tiles(K, SM90_MATMUL_TILES["bk"]),
            "double_buffer": [False, True],
        }
    if kind == "tpu":
        return {
            "bm": _divisors_pow2(M, 8, 512),
            "bn": _divisors_pow2(N, 128, 1024),
            "bk": _divisors_pow2(K, 128, 2048),
            "double_buffer": [False, True],
        }
    return {
        "bm": _divisors_pow2(M, 4, 256),
        "bn": _divisors_pow2(N, 8, 512),
        "bk": _divisors_pow2(K, 8, 512),
        "order": ["ikj", "kij"],
        "unroll_i": [1, 2, 4],
    }


def _matmul_tpu(attrs: Dict, cfg: Dict,
                kind: str) -> Tuple[Program, ScheduleMeta]:
    """TPU and sm90: grid block loops + matrix-unit nest (on sm90 the grid
    is the set of (bm, bn) output tiles, the ``gk`` block loop the K loop
    inside each thread block, one TMA stage of A and B per step). The grid
    extents are ceil(dim / tile), so a ragged last tile counts whole; the
    ``tpu`` knobs always divide, where ceil is floor."""
    M, N, K, db = attrs["M"], attrs["N"], attrs["K"], attrs["dtype_bytes"]
    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    gm, gn, gk = -(-M // bm), -(-N // bn), -(-K // bk)
    A = TensorDecl("A", (M, K), db)
    B = TensorDecl("B", (K, N), db)
    C = TensorDecl("C", (M, N), db)

    stmt = Compute(
        "fma",
        output=Access("C", (
            LinExpr.of(("gm", bm), ("tm", 1)),
            LinExpr.of(("gn", bn), ("tn", 1)),
        ), is_store=True),
        inputs=(
            Access("A", (LinExpr.of(("gm", bm), ("tm", 1)),
                         LinExpr.of(("gk", bk), ("tk", 1)))),
            Access("B", (LinExpr.of(("gk", bk), ("tk", 1)),
                         LinExpr.of(("gn", bn), ("tn", 1)))),
        ),
    )
    nest = Loop("tm", bm, (Loop("tn", bn, (Loop("tk", bk, (stmt,),
                "tensor.k"),), "tensor.n"),), "tensor.m")
    kloop = Loop("gk", gk, (nest,), "block")  # grid reduction dim
    grid_n = Loop("gn", gn, (kloop,), "serial")
    grid_m = Loop("gm", gm, (grid_n,), "serial")
    prog = Program((A, B, C), (grid_m,), name=f"matmul_{M}x{N}x{K}")
    if kind == "sm90":
        tile_bytes = sm90_matmul_smem_bytes(bm, bn, bk, db)
    else:
        tile_bytes = (bm * bk + bk * bn + bm * bn) * db
    meta = ScheduleMeta(
        grid_size=gm * gn * gk,
        double_buffer=cfg["double_buffer"],
        parallel_extent=gm * gn,
        vmem_tile_bytes=tile_bytes,
    )
    return prog, meta


def _matmul_cpu(attrs: Dict, cfg: Dict) -> Tuple[Program, ScheduleMeta]:
    """CPU/GPU SIMD: cache tiling + vector j (+ unrolled i)."""
    M, N, K, db = attrs["M"], attrs["N"], attrs["K"], attrs["dtype_bytes"]
    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    u = min(cfg["unroll_i"], bm)
    A = TensorDecl("A", (M, K), db)
    B = TensorDecl("B", (K, N), db)
    C = TensorDecl("C", (M, N), db)
    stmt = Compute(
        "fma",
        output=Access("C", (
            LinExpr.of(("it", bm), ("i", 1)),
            LinExpr.of(("jt", bn), ("j", 1)),
        ), is_store=True),
        inputs=(
            Access("A", (LinExpr.of(("it", bm), ("i", 1)),
                         LinExpr.of(("kt", bk), ("k", 1)))),
            Access("B", (LinExpr.of(("kt", bk), ("k", 1)),
                         LinExpr.of(("jt", bn), ("j", 1)))),
        ),
    )
    jv = Loop("j", bn, (stmt,), "vector")
    if cfg["order"] == "ikj":
        inner = Loop("i", bm // u, (Loop("iu", u, (Loop("k", bk, (jv,),
                     "serial"),), "unroll"),), "serial")
    else:  # kij
        inner = Loop("k", bk, (Loop("i", bm // u, (Loop("iu", u, (jv,),
                     "unroll"),), "serial"),), "serial")
    kt = Loop("kt", K // bk, (inner,), "serial")
    jt = Loop("jt", N // bn, (kt,), "serial")
    it = Loop("it", M // bm, (jt,), "serial")
    prog = Program((A, B, C), (it,), name=f"matmul_{M}x{N}x{K}")
    meta = ScheduleMeta(
        grid_size=(M // bm) * (N // bn) * (K // bk),  # block dispatches
        parallel_extent=M // bm,
        vmem_tile_bytes=0,
    )
    return prog, meta


def _build_matmul(attrs: Dict, cfg: Dict,
                  kind: str) -> Tuple[Program, ScheduleMeta]:
    if kind in ("tpu", "sm90"):
        return _matmul_tpu(attrs, cfg, kind)
    return _matmul_cpu(attrs, cfg)


def _matmul_bundle(attrs: Dict, config: Dict) -> BundleSpec:
    dtype = DTYPE_BY_BYTES.get(attrs["dtype_bytes"])
    if dtype is None:
        raise BundleSkip("unsupported dtype_bytes")
    if not {"bm", "bn", "bk"} <= set(config):
        raise BundleSkip("no TPU block schedule in config (cpu-knob record)")
    M, N, K = attrs["M"], attrs["N"], attrs["K"]
    return BundleSpec("matmul",
                      (((M, K), dtype), ((K, N), dtype)), {})


# the choice superset ("ijk" included) pins the historical learned-ranker
# one-hot layout even though the cpu knob generator only offers ikj/kij
MATMUL_KNOB_FEATURES = (
    KnobFeature("bm", "log2"),
    KnobFeature("bn", "log2"),
    KnobFeature("bk", "log2"),
    KnobFeature("unroll_i", "raw"),
    KnobFeature("double_buffer", "flag"),
    KnobFeature("order", "choice", ("ikj", "kij", "ijk")),
)

MATMUL_DEF = register(OpDef(
    name="matmul",
    attrs=(AttrSpec("M"), AttrSpec("N"), AttrSpec("K"),
           AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_matmul_knobs,
    build_fn=_build_matmul,
    bundle_fn=_matmul_bundle,
    knob_features=MATMUL_KNOB_FEATURES,
    presets={
        "dense_256": Preset({"M": 256, "N": 256, "K": 256}, "cpu"),
        "dense_512": Preset({"M": 512, "N": 512, "K": 512}, "cpu"),
        # bf16 TPU matmul shapes the kernel block-spec picker asks for at
        # trace time — tuning these warms the DB tuned_matmul_blocks consults
        "matmul_1024_bf16": Preset(
            {"M": 1024, "N": 1024, "K": 1024, "dtype_bytes": 2}, "tpu"),
        "matmul_2048_bf16": Preset(
            {"M": 2048, "N": 2048, "K": 2048, "dtype_bytes": 2}, "tpu"),
        "matmul_4096_bf16": Preset(
            {"M": 4096, "N": 4096, "K": 4096, "dtype_bytes": 2}, "tpu"),
    },
    doc="C[M,N] += A[M,K] @ B[K,N]",
))


class MatmulSpace(RegistrySpace):
    name = "matmul"

    def __init__(self, M: int, N: int, K: int, dtype_bytes: int = 4,
                 target_kind: str = "tpu"):
        RegistrySpace.__init__(
            self, MATMUL_DEF,
            {"M": M, "N": N, "K": K, "dtype_bytes": dtype_bytes},
            target_kind)


MATMUL_DEF.space_cls = MatmulSpace


def _build_batch_matmul(attrs: Dict, cfg: Dict,
                        kind: str) -> Tuple[Program, ScheduleMeta]:
    prog, meta = _build_matmul(attrs, cfg, kind)
    return _wrap_parallel(prog, meta, (("b", attrs["Bsz"]),),
                          f"bmm_{attrs['Bsz']}x{attrs['M']}")


BATCH_MATMUL_DEF = register(OpDef(
    name="batch_matmul",
    attrs=(AttrSpec("Bsz"), AttrSpec("M"), AttrSpec("N"), AttrSpec("K"),
           AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_matmul_knobs,
    build_fn=_build_batch_matmul,
    knob_features=MATMUL_KNOB_FEATURES,
    presets={
        "batch_matmul": Preset(
            {"Bsz": 8, "M": 128, "N": 128, "K": 64}, "cpu"),
    },
    doc="C[b,M,N] += A[b,M,K] @ B[b,K,N]",
))


class BatchMatmulSpace(MatmulSpace):
    name = "batch_matmul"

    def __init__(self, Bsz: int, M: int, N: int, K: int,
                 dtype_bytes: int = 4, target_kind: str = "tpu"):
        RegistrySpace.__init__(
            self, BATCH_MATMUL_DEF,
            {"Bsz": Bsz, "M": M, "N": N, "K": K,
             "dtype_bytes": dtype_bytes},
            target_kind)


BATCH_MATMUL_DEF.space_cls = BatchMatmulSpace


# ---------------------------------------------------------------------------
# Conv2d (NHWC, direct)
# ---------------------------------------------------------------------------


def _conv2d_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    return {
        "b_oc": _divisors_pow2(attrs["Cout"], 8, 256),
        "b_ow": _divisors_pow2(attrs["W"], 2, 64),
        "b_ic": _divisors_pow2(attrs["Cin"], 8, 256),
    }


def _build_conv2d(attrs: Dict, cfg: Dict,
                  kind: str) -> Tuple[Program, ScheduleMeta]:
    N, H, W = attrs["N"], attrs["H"], attrs["W"]
    Cin, Cout = attrs["Cin"], attrs["Cout"]
    KH, KW, db = attrs["KH"], attrs["KW"], attrs["dtype_bytes"]
    b_oc, b_ow, b_ic = cfg["b_oc"], cfg["b_ow"], cfg["b_ic"]
    X = TensorDecl("X", (N, H + KH - 1, W + KW - 1, Cin), db)
    Wt = TensorDecl("W", (KH, KW, Cin, Cout), db)
    Y = TensorDecl("Y", (N, H, W, Cout), db)
    # Y[n, oh, owt*b+ow, oct*b+oc] += X[n, oh+kh, owt*b+ow+kw, ict*b+ic]
    #                                 * W[kh, kw, ict*b+ic, oct*b+oc]
    stmt = Compute(
        "fma",
        output=Access("Y", (
            LinExpr.var("n"), LinExpr.var("oh"),
            LinExpr.of(("owt", b_ow), ("ow", 1)),
            LinExpr.of(("oct", b_oc), ("oc", 1)),
        ), is_store=True),
        inputs=(
            Access("X", (
                LinExpr.var("n"),
                LinExpr.of(("oh", 1), ("kh", 1)),
                LinExpr.of(("owt", b_ow), ("ow", 1), ("kw", 1)),
                LinExpr.of(("ict", b_ic), ("ic", 1)),
            )),
            Access("W", (
                LinExpr.var("kh"), LinExpr.var("kw"),
                LinExpr.of(("ict", b_ic), ("ic", 1)),
                LinExpr.of(("oct", b_oc), ("oc", 1)),
            )),
        ),
    )
    if kind == "tpu":
        # im2col mapping: (ow x ic) micro-tile on the MXU
        nest = Loop("ow", b_ow, (Loop("oc", b_oc, (Loop(
            "ic", b_ic, (stmt,), "tensor.k"),), "tensor.n"),), "tensor.m")
    else:
        nest = Loop("ow", b_ow, (Loop("ic", b_ic, (Loop(
            "oc", b_oc, (stmt,), "vector"),), "serial"),), "serial")
    kw_l = Loop("kw", KW, (nest,), "serial")
    kh_l = Loop("kh", KH, (kw_l,), "serial")
    ict = Loop("ict", Cin // b_ic, (kh_l,),
               "block" if kind == "tpu" else "serial")
    owt = Loop("owt", W // b_ow, (ict,), "serial")
    oct_ = Loop("oct", Cout // b_oc, (owt,), "serial")
    oh_l = Loop("oh", H, (oct_,), "serial")
    n_l = Loop("n", N, (oh_l,), "parallel")
    prog = Program((X, Wt, Y), (n_l,),
                   name=f"conv2d_{N}x{H}x{W}x{Cin}x{Cout}")
    tile = (b_ow * b_ic + b_ic * b_oc + b_ow * b_oc) * db
    meta = ScheduleMeta(
        grid_size=N * H * (Cout // b_oc) * (W // b_ow),
        parallel_extent=N * H,
        vmem_tile_bytes=tile,
        double_buffer=False,
    )
    return prog, meta


CONV2D_DEF = register(OpDef(
    name="conv2d",
    attrs=(AttrSpec("N"), AttrSpec("H"), AttrSpec("W"),
           AttrSpec("Cin"), AttrSpec("Cout"),
           AttrSpec("KH", int, 3), AttrSpec("KW", int, 3),
           AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_conv2d_knobs,
    build_fn=_build_conv2d,
    knob_features=(
        KnobFeature("b_oc", "log2"),
        KnobFeature("b_ow", "log2"),
        KnobFeature("b_ic", "log2"),
    ),
    presets={
        "conv2d": Preset({"N": 1, "H": 14, "W": 14, "Cin": 256,
                          "Cout": 256}, "cpu"),
    },
    doc="direct NHWC conv2d",
))


class Conv2dSpace(RegistrySpace):
    name = "conv2d"

    def __init__(self, N: int, H: int, W: int, Cin: int, Cout: int,
                 KH: int = 3, KW: int = 3, dtype_bytes: int = 4,
                 target_kind: str = "cpu"):
        RegistrySpace.__init__(
            self, CONV2D_DEF,
            {"N": N, "H": H, "W": W, "Cin": Cin, "Cout": Cout,
             "KH": KH, "KW": KW, "dtype_bytes": dtype_bytes},
            target_kind)


CONV2D_DEF.space_cls = Conv2dSpace


def _depthwise_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    return {
        "b_c": _divisors_pow2(attrs["C"], 8, 512),
        "b_ow": _divisors_pow2(attrs["W"], 2, 64),
    }


def _build_depthwise(attrs: Dict, cfg: Dict,
                     kind: str) -> Tuple[Program, ScheduleMeta]:
    N, H, W, C = attrs["N"], attrs["H"], attrs["W"], attrs["C"]
    KH, KW, db = attrs["KH"], attrs["KW"], attrs["dtype_bytes"]
    b_c, b_ow = cfg["b_c"], cfg["b_ow"]
    X = TensorDecl("X", (N, H + KH - 1, W + KW - 1, C), db)
    Wt = TensorDecl("W", (KH, KW, C), db)
    Y = TensorDecl("Y", (N, H, W, C), db)
    stmt = Compute(
        "fma",
        output=Access("Y", (
            LinExpr.var("n"), LinExpr.var("oh"),
            LinExpr.of(("owt", b_ow), ("ow", 1)),
            LinExpr.of(("ct", b_c), ("c", 1)),
        ), is_store=True),
        inputs=(
            Access("X", (
                LinExpr.var("n"), LinExpr.of(("oh", 1), ("kh", 1)),
                LinExpr.of(("owt", b_ow), ("ow", 1), ("kw", 1)),
                LinExpr.of(("ct", b_c), ("c", 1)),
            )),
            Access("W", (LinExpr.var("kh"), LinExpr.var("kw"),
                         LinExpr.of(("ct", b_c), ("c", 1)))),
        ),
    )
    cv = Loop("c", b_c, (stmt,), "vector")
    ow_l = Loop("ow", b_ow, (cv,), "serial")
    kw_l = Loop("kw", KW, (ow_l,), "serial")
    kh_l = Loop("kh", KH, (kw_l,), "serial")
    ct = Loop("ct", C // b_c, (kh_l,),
              "block" if kind == "tpu" else "serial")
    owt = Loop("owt", W // b_ow, (ct,), "serial")
    oh_l = Loop("oh", H, (owt,), "serial")
    n_l = Loop("n", N, (oh_l,), "parallel")
    prog = Program((X, Wt, Y), (n_l,), name=f"dwconv_{N}x{H}x{W}x{C}")
    meta = ScheduleMeta(
        grid_size=N * H * (C // b_c),
        parallel_extent=N * H,
        vmem_tile_bytes=(2 * b_ow * b_c + KH * KW * b_c) * db,
    )
    return prog, meta


DEPTHWISE_DEF = register(OpDef(
    name="depthwise_conv2d",
    attrs=(AttrSpec("N"), AttrSpec("H"), AttrSpec("W"), AttrSpec("C"),
           AttrSpec("KH", int, 3), AttrSpec("KW", int, 3),
           AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_depthwise_knobs,
    build_fn=_build_depthwise,
    knob_features=(
        KnobFeature("b_c", "log2"),
        KnobFeature("b_ow", "log2"),
    ),
    presets={
        "depthwise_conv2d": Preset({"N": 1, "H": 28, "W": 28, "C": 128},
                                   "cpu"),
    },
    doc="per-channel NHWC conv (VPU-only on TPU)",
))


class DepthwiseConv2dSpace(RegistrySpace):
    name = "depthwise_conv2d"

    def __init__(self, N: int, H: int, W: int, C: int, KH: int = 3,
                 KW: int = 3, dtype_bytes: int = 4,
                 target_kind: str = "cpu"):
        RegistrySpace.__init__(
            self, DEPTHWISE_DEF,
            {"N": N, "H": H, "W": W, "C": C, "KH": KH, "KW": KW,
             "dtype_bytes": dtype_bytes},
            target_kind)


DEPTHWISE_DEF.space_cls = DepthwiseConv2dSpace
