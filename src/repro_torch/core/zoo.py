"""Model-zoo operator families registered with the declarative registry.

The port's own copy of ``repro.core.zoo``, registered in the reference's
order, so that the learned ranker's knob columns
(``op_registry.knob_feature_union``) are the reference's:

  * ``moe_dispatch`` — the per-(batch, expert) token GEMM behind the MoE
    dispatch: C tokens of width D against an expert FFN of width F, wrapped
    in a (B, E) parallel grid; its knobs are matmul's.
  * ``ssm_scan`` — the chunked selective scan: per chunk a state update
    H[n,d] += B[t,n]·X[t,d] and an output contraction Y[t,d] += C[t,n]·H[n,d],
    tiled over (chunk, b_d).
  * ``mlstm_chunk`` — the chunkwise mLSTM recurrence: per R-row chunk an
    (R×R) score GEMM then an (R×dh) output GEMM, tiled over (br, bh).
  * ``flash`` / ``flash_gqa`` — attention spaces whose knobs are the flash
    kernel's ``block_q``/``block_k``. ``flash`` keeps the single-head
    signature the block picker (``kernels/ops.tuned_flash_blocks``) keys
    its records by; ``flash_gqa`` adds head-group and causal attributes.

No model consumes the picks of the first three: they are store families,
tuned, stored and featurized like the others. Signatures are the
reference's for the same attributes, so records are interchangeable. On
the port's ``sm90`` kind the first three take the staged form (a block
loop and the ``double_buffer`` knob), as ``flash`` does, and
``moe_dispatch`` takes the Hopper matmul tiles.

For the reference's kinds the knobs are the reference's (power-of-two
divisors of S from 128 to 1024). For the port's ``sm90`` kind they are the
blocks the Hopper kernel (``kernels/csrc/flash_attention.cu``) is built
for, whether or not they divide S: the kernel takes ragged tiles, and serve
prompts of 77, 300 and 513 tokens reach it. ``_build_flash`` counts a
ragged tile whole, as the kernel runs it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.cost_model import ScheduleMeta
from repro_torch.core.op_registry import (
    DTYPE_BY_BYTES,
    AttrSpec,
    BundleSkip,
    BundleSpec,
    KnobFeature,
    OpDef,
    Preset,
    register,
)
from repro_torch.core.spaces import (
    MATMUL_KNOB_FEATURES,
    _build_matmul,
    _divisors_pow2,
    _matmul_knobs,
    _wrap_parallel,
)
from repro_torch.core.tir import Access, Compute, LinExpr, Loop, Program, TensorDecl

__all__ = ["MOE_DISPATCH_DEF", "SSM_SCAN_DEF", "MLSTM_CHUNK_DEF", "FLASH_DEF",
           "FLASH_GQA_DEF", "SM90_FLASH_BLOCKS", "sm90_flash_smem_bytes",
           "sm90_padded_head_dim"]

_STAGED = ("tpu", "gpu", "sm90")  # kinds with an explicit fast-memory staging loop


# ---------------------------------------------------------------------------
# MoE token-dispatch GEMM
# ---------------------------------------------------------------------------


def _moe_matmul_attrs(attrs: Dict) -> Dict:
    return {"M": attrs["C"], "N": attrs["F"], "K": attrs["D"],
            "dtype_bytes": attrs["dtype_bytes"]}


def _moe_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    return _matmul_knobs(_moe_matmul_attrs(attrs), kind)


def _build_moe_dispatch(attrs: Dict, cfg: Dict,
                        kind: str) -> Tuple[Program, ScheduleMeta]:
    prog, meta = _build_matmul(_moe_matmul_attrs(attrs), cfg, kind)
    B, E = attrs["B"], attrs["E"]
    return _wrap_parallel(prog, meta, (("b", B), ("e", E)),
                          f"moe_dispatch_{B}x{E}x{attrs['C']}")


MOE_DISPATCH_DEF = register(OpDef(
    name="moe_dispatch",
    attrs=(AttrSpec("B"), AttrSpec("E"), AttrSpec("C"), AttrSpec("D"),
           AttrSpec("F"), AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_moe_knobs,
    build_fn=_build_moe_dispatch,
    knob_features=MATMUL_KNOB_FEATURES,
    presets={
        "moe_dispatch": Preset(
            {"B": 2, "E": 8, "C": 128, "D": 256, "F": 512}, "cpu"),
    },
    doc="per-(batch, expert) token GEMM: Y[b,e,C,F] += X[b,e,C,D] @ W[b,e,D,F]",
))


# ---------------------------------------------------------------------------
# SSM chunked selective scan
# ---------------------------------------------------------------------------


def _ssm_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    knobs: Dict[str, List] = {
        "chunk": _divisors_pow2(attrs["S"], 8, 256),
        "b_d": _divisors_pow2(attrs["D"], 8, 512),
    }
    if kind in _STAGED:
        knobs["double_buffer"] = [False, True]
    return knobs


def _build_ssm_scan(attrs: Dict, cfg: Dict,
                    kind: str) -> Tuple[Program, ScheduleMeta]:
    S, D, N, db = attrs["S"], attrs["D"], attrs["N"], attrs["dtype_bytes"]
    chunk, b_d = cfg["chunk"], cfg["b_d"]
    X = TensorDecl("X", (S, D), db)
    Bm = TensorDecl("Bm", (S, N), db)
    Cm = TensorDecl("Cm", (S, N), db)
    Hs = TensorDecl("H", (N, D), db)
    Y = TensorDecl("Y", (S, D), db)
    row = LinExpr.of(("ci", chunk), ("tu", 1))
    col = LinExpr.of(("dt", b_d), ("dv", 1))
    # state update: H[n, d] += Bm[t, n] * X[t, d]
    upd = Compute(
        "fma",
        output=Access("H", (LinExpr.var("n"), col), is_store=True),
        inputs=(Access("Bm", (row, LinExpr.var("n"))),
                Access("X", (row, col))),
    )
    row_o = LinExpr.of(("ci", chunk), ("to", 1))
    col_o = LinExpr.of(("dt", b_d), ("dw", 1))
    # output contraction: Y[t, d] += Cm[t, n] * H[n, d]
    out = Compute(
        "fma",
        output=Access("Y", (row_o, col_o), is_store=True),
        inputs=(Access("Cm", (row_o, LinExpr.var("no"))),
                Access("H", (LinExpr.var("no"), col_o))),
    )
    upd_nest = Loop("tu", chunk, (Loop("n", N, (Loop(
        "dv", b_d, (upd,), "vector"),), "serial"),), "serial")
    out_nest = Loop("to", chunk, (Loop("no", N, (Loop(
        "dw", b_d, (out,), "vector"),), "serial"),), "serial")
    dt = Loop("dt", D // b_d, (upd_nest, out_nest), "serial")
    ci = Loop("ci", S // chunk, (dt,),
              "block" if kind in _STAGED else "serial")
    prog = Program((X, Bm, Cm, Hs, Y), (ci,),
                   name=f"ssm_scan_{S}x{D}x{N}")
    meta = ScheduleMeta(
        grid_size=(S // chunk) * (D // b_d),
        parallel_extent=D // b_d,  # the scan itself is serial over chunks
        vmem_tile_bytes=(chunk * b_d + 2 * chunk * N + N * b_d) * db,
        double_buffer=bool(cfg.get("double_buffer", False)),
    )
    return _wrap_parallel(prog, meta, (("b", attrs["B"]),),
                          f"ssm_scan_{attrs['B']}x{S}x{D}")


SSM_SCAN_DEF = register(OpDef(
    name="ssm_scan",
    attrs=(AttrSpec("B"), AttrSpec("S"), AttrSpec("D"), AttrSpec("N"),
           AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_ssm_knobs,
    build_fn=_build_ssm_scan,
    knob_features=(
        KnobFeature("chunk", "log2"),
        KnobFeature("b_d", "log2"),
        KnobFeature("double_buffer", "flag"),
    ),
    presets={
        "ssm_scan": Preset({"B": 2, "S": 512, "D": 256, "N": 16}, "cpu"),
    },
    doc="chunked selective scan: H += B·X per chunk, Y += C·H",
))


# ---------------------------------------------------------------------------
# mLSTM chunkwise recurrence
# ---------------------------------------------------------------------------


def _mlstm_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    knobs: Dict[str, List] = {
        "br": _divisors_pow2(attrs["R"], 8, 128),
        "bh": _divisors_pow2(attrs["dh"], 8, 128),
    }
    if kind in _STAGED:
        knobs["double_buffer"] = [False, True]
    return knobs


def _build_mlstm_chunk(attrs: Dict, cfg: Dict,
                       kind: str) -> Tuple[Program, ScheduleMeta]:
    S, R, dh = attrs["S"], attrs["R"], attrs["dh"]
    db = attrs["dtype_bytes"]
    br, bh = cfg["br"], cfg["bh"]
    Q = TensorDecl("Q", (S, dh), db)
    K = TensorDecl("K", (S, dh), db)
    V = TensorDecl("V", (S, dh), db)
    Sc = TensorDecl("Sc", (S, R), 4)   # f32 score chunk
    O = TensorDecl("O", (S, dh), db)
    q_row = LinExpr.of(("ci", R), ("rt", br), ("tm", 1))
    # scores: Sc[q, r] += Q[q, :] · K[ci*R + r, :]
    score = Compute(
        "fma",
        output=Access("Sc", (q_row, LinExpr.var("tn")), is_store=True),
        inputs=(Access("Q", (q_row, LinExpr.var("tk"))),
                Access("K", (LinExpr.of(("ci", R), ("tn", 1)),
                             LinExpr.var("tk")))),
    )
    score_nest = Loop("tm", br, (Loop("tn", R, (Loop(
        "tk", dh, (score,), "tensor.k"),), "tensor.n"),), "tensor.m")
    o_row = LinExpr.of(("ci", R), ("rt", br), ("om", 1))
    o_col = LinExpr.of(("ht", bh), ("on", 1))
    # output: O[q, h] += Sc[q, r] * V[ci*R + r, h]
    outc = Compute(
        "fma",
        output=Access("O", (o_row, o_col), is_store=True),
        inputs=(Access("Sc", (o_row, LinExpr.var("ok"))),
                Access("V", (LinExpr.of(("ci", R), ("ok", 1)), o_col))),
    )
    out_nest = Loop("om", br, (Loop("on", bh, (Loop(
        "ok", R, (outc,), "tensor.k"),), "tensor.n"),), "tensor.m")
    ht = Loop("ht", dh // bh, (out_nest,), "serial")
    rt = Loop("rt", R // br, (score_nest, ht), "serial")
    ci = Loop("ci", S // R, (rt,),
              "block" if kind in _STAGED else "serial")
    prog = Program((Q, K, V, Sc, O), (ci,), name=f"mlstm_chunk_{S}x{R}x{dh}")
    meta = ScheduleMeta(
        grid_size=S // R,
        parallel_extent=1,  # the chunk recurrence is serial
        vmem_tile_bytes=(3 * R * dh) * db + R * R * 4,
        double_buffer=bool(cfg.get("double_buffer", False)),
    )
    return _wrap_parallel(prog, meta,
                          (("b", attrs["B"]), ("h", attrs["H"])),
                          f"mlstm_{attrs['B']}x{attrs['H']}x{S}")


MLSTM_CHUNK_DEF = register(OpDef(
    name="mlstm_chunk",
    attrs=(AttrSpec("B"), AttrSpec("H"), AttrSpec("S"), AttrSpec("R"),
           AttrSpec("dh"), AttrSpec("dtype_bytes", int, 4)),
    knob_fn=_mlstm_knobs,
    build_fn=_build_mlstm_chunk,
    knob_features=(
        KnobFeature("br", "log2"),
        KnobFeature("bh", "log2"),
        KnobFeature("double_buffer", "flag"),
    ),
    presets={
        "mlstm_chunk": Preset(
            {"B": 1, "H": 4, "S": 512, "R": 64, "dh": 64}, "cpu"),
    },
    doc="chunkwise mLSTM: per chunk an RxR score GEMM then an Rxdh out GEMM",
))


# block_q / block_k values the Hopper flash kernel is built for (one or two
# consumer warpgroups of 64 query rows; K/V tiles of 64 or 128 keys)
SM90_FLASH_BLOCKS: Tuple[int, ...] = (64, 128)


def sm90_padded_head_dim(d: int) -> int:
    """The width the Hopper kernel stages a head dim at: whole 64-column
    swizzle atoms (80 -> 128; the columns past ``d`` are TMA's zero fill),
    and past 256 whole pairs of them (384 or 512: two output chunks of
    whole atoms)."""
    return -(-d // 64) * 64 if d <= 256 else -(-d // 128) * 128


def sm90_flash_smem_bytes(block_q: int, block_k: int, d: int,
                          dtype_bytes: int = 2) -> int:
    """Dynamic shared memory of the Hopper kernel at these blocks, as its
    ``Cfg`` computes it. In bf16 and f16 (``dtype_bytes=2``): the Q tile, two
    stages of K and V tiles at the padded head dim, 128 bytes of barriers
    and 1024 bytes of slack to align the tiles to the 1024-byte swizzle
    period; past 256 columns one stage, of a K tile at the padded width and
    a V tile of one output chunk (half of it). In f32 (``dtype_bytes=4``),
    the three-pass TF32 kernels, with 128 bytes of barriers and 1024 of
    slack: up to 128 columns ``CfgTf32``, Q's hi and lo, one K tile (its
    hi) and its lo, one V tile as it lands and V^T's hi and lo, all f32;
    past 128 columns ``CfgTf32Wide``, Q's hi and lo and a ring of stages,
    each a 64-column K or V chunk's hi and lo (block_k x 64 f32 each), 4 at
    192 columns and 3 at 256 (what fits beside Q at (64, 64)). No kernel
    takes another width; it is counted as 16-bit."""
    dp = sm90_padded_head_dim(d)
    if dtype_bytes == 4:
        if dp <= 128:
            return 4 * (2 * block_q * dp + 5 * block_k * dp) + 128 + 1024
        stages = 4 if dp == 192 else 3
        return 4 * (2 * block_q * dp + stages * 2 * block_k * 64) + 128 + 1024
    if dp > 256:
        return 2 * (dp * (block_q + block_k) + dp // 2 * block_k) + 128 + 1024
    return 2 * dp * (block_q + 2 * 2 * block_k) + 128 + 1024


def _flash_knobs(attrs: Dict, kind: str) -> Dict[str, List]:
    if kind == "sm90":
        return {"block_q": list(SM90_FLASH_BLOCKS),
                "block_k": list(SM90_FLASH_BLOCKS)}
    s = attrs["s"]
    return {
        "block_q": _divisors_pow2(s, 128, 1024),
        "block_k": _divisors_pow2(s, 128, 1024),
    }


def _build_flash(attrs: Dict, cfg: Dict,
                 kind: str) -> Tuple[Program, ScheduleMeta]:
    s, d, db = attrs["s"], attrs["d"], attrs["dtype_bytes"]
    hq = attrs.get("hq", 1)
    bq, bk = cfg["block_q"], cfg["block_k"]
    nq, nk = -(-s // bq), -(-s // bk)  # a ragged tile counts whole
    # one head's online-softmax tile stream; heads only scale the grid
    Q = TensorDecl("Q", (s, d), db)
    K = TensorDecl("K", (s, d), db)
    V = TensorDecl("V", (s, d), db)
    P = TensorDecl("P", (s, bk), 4)    # f32 probability tile
    O = TensorDecl("O", (s, d), db)
    q_row = LinExpr.of(("qi", bq), ("tm", 1))
    score = Compute(
        "fma",
        output=Access("P", (q_row, LinExpr.var("tn")), is_store=True),
        inputs=(Access("Q", (q_row, LinExpr.var("tk"))),
                Access("K", (LinExpr.of(("ki", bk), ("tn", 1)),
                             LinExpr.var("tk")))),
    )
    score_nest = Loop("tm", bq, (Loop("tn", bk, (Loop(
        "tk", d, (score,), "tensor.k"),), "tensor.n"),), "tensor.m")
    e_row = LinExpr.of(("qi", bq), ("te", 1))
    expc = Compute(
        "exp",
        output=Access("P", (e_row, LinExpr.var("tj")), is_store=True),
        inputs=(Access("P", (e_row, LinExpr.var("tj"))),),
    )
    exp_nest = Loop("te", bq, (Loop("tj", bk, (expc,), "vector"),), "serial")
    o_row = LinExpr.of(("qi", bq), ("om", 1))
    outc = Compute(
        "fma",
        output=Access("O", (o_row, LinExpr.var("on")), is_store=True),
        inputs=(Access("P", (o_row, LinExpr.var("ok"))),
                Access("V", (LinExpr.of(("ki", bk), ("ok", 1)),
                             LinExpr.var("on")))),
    )
    out_nest = Loop("om", bq, (Loop("on", d, (Loop(
        "ok", bk, (outc,), "tensor.k"),), "tensor.n"),), "tensor.m")
    ki = Loop("ki", nk, (score_nest, exp_nest, out_nest),
              "block" if kind in _STAGED else "serial")
    qi = Loop("qi", nq, (ki,), "serial")
    prog = Program((Q, K, V, P, O), (qi,), name=f"flash_{hq}x{s}x{d}")
    if kind == "sm90":
        # what the Hopper kernel stages: its whole dynamic shared memory
        vmem = sm90_flash_smem_bytes(bq, bk, d, db)
    else:
        # the reference's VMEM estimate: q/o blocks + k/v blocks + the m/l
        # softmax carries and the probability tile
        vmem = (bq * d + 2 * bk * d + bq * d) * db + bq * (2 * 128 + bk) * 4
    meta = ScheduleMeta(
        grid_size=hq * nq * nk,
        parallel_extent=hq * nq,
        vmem_tile_bytes=vmem,
        double_buffer=False,
    )
    return prog, meta


def _flash_bundle(attrs: Dict, config: Dict) -> BundleSpec:
    dtype = DTYPE_BY_BYTES.get(attrs["dtype_bytes"])
    if dtype is None:
        raise BundleSkip("unsupported dtype_bytes")
    if not {"block_q", "block_k"} <= set(config):
        raise BundleSkip("no block_q/block_k in config")
    s, d = attrs["s"], attrs["d"]
    shape = (1, 1, s, d)   # canonical single-head, batch-1 layout
    return BundleSpec("flash", ((shape, dtype),) * 3,
                      {"causal": True, "scale": d ** -0.5})


FLASH_DEF = register(OpDef(
    name="flash",
    attrs=(AttrSpec("s"), AttrSpec("d"), AttrSpec("dtype_bytes", int, 2)),
    knob_fn=_flash_knobs,
    build_fn=_build_flash,
    bundle_fn=_flash_bundle,
    knob_features=(
        KnobFeature("block_q", "log2"),
        KnobFeature("block_k", "log2"),
    ),
    presets={
        "flash_1024": Preset({"s": 1024, "d": 64}, "tpu"),
    },
    doc="single-head flash attention block grid (the block picker's signature)",
))


def _gqa_bundle(attrs: Dict, config: Dict) -> BundleSpec:
    dtype = DTYPE_BY_BYTES.get(attrs["dtype_bytes"])
    if dtype is None:
        raise BundleSkip("unsupported dtype_bytes")
    if not {"block_q", "block_k"} <= set(config):
        raise BundleSkip("no block_q/block_k in config")
    s, d = attrs["s"], attrs["d"]
    hq, hkv = attrs["hq"], attrs["hkv"]
    if hq % hkv:
        raise BundleSkip("hq must be a multiple of hkv")
    q_aval = ((1, hq, s, d), dtype)
    kv_aval = ((1, hkv, s, d), dtype)
    return BundleSpec("flash", (q_aval, kv_aval, kv_aval),
                      {"causal": attrs["causal"], "scale": d ** -0.5})


FLASH_GQA_DEF = register(OpDef(
    name="flash_gqa",
    attrs=(AttrSpec("s"), AttrSpec("d"), AttrSpec("hq"), AttrSpec("hkv"),
           AttrSpec("causal", bool, True),
           AttrSpec("dtype_bytes", int, 2)),
    knob_fn=_flash_knobs,
    build_fn=_build_flash,
    bundle_fn=_gqa_bundle,
    knob_features=(
        KnobFeature("block_q", "log2"),
        KnobFeature("block_k", "log2"),
    ),
    presets={
        "flash_gqa": Preset(
            {"s": 512, "d": 64, "hq": 8, "hkv": 2, "causal": True}, "tpu"),
    },
    doc="grouped-query flash attention: hq query heads over hkv kv heads",
))
