"""Model-zoo operator families registered with the declarative registry.

The port's own copy of the attention half of ``repro.core.zoo``: the
``flash`` and ``flash_gqa`` families, whose knobs are the flash kernel's
``block_q``/``block_k``. ``flash`` keeps the single-head signature the
block picker (``kernels/ops.tuned_flash_blocks``) keys its records by;
``flash_gqa`` adds head-group and causal attributes. Signatures are the
reference's for the same attributes, so records are interchangeable.

For the reference's kinds the knobs are the reference's (power-of-two
divisors of S from 128 to 1024). For the port's ``sm90`` kind they are the
blocks the Hopper kernel (``kernels/csrc/flash_attention.cu``) is built
for, whether or not they divide S: the kernel takes ragged tiles, and serve
prompts of 77, 300 and 513 tokens reach it. ``_build_flash`` counts a
ragged tile whole, as the kernel runs it.

The reference's ``moe_dispatch``, ``ssm_scan`` and ``mlstm_chunk``
families wait for ROADMAP Queue A 9.
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
from repro_torch.core.spaces import _divisors_pow2
from repro_torch.core.tir import Access, Compute, LinExpr, Loop, Program, TensorDecl

__all__ = ["FLASH_DEF", "FLASH_GQA_DEF", "SM90_FLASH_BLOCKS",
           "sm90_flash_smem_bytes", "sm90_padded_head_dim"]

_STAGED = ("tpu", "gpu", "sm90")  # kinds with an explicit fast-memory staging loop

# block_q / block_k values the Hopper flash kernel is built for (one or two
# consumer warpgroups of 64 query rows; K/V tiles of 64 or 128 keys)
SM90_FLASH_BLOCKS: Tuple[int, ...] = (64, 128)


def sm90_padded_head_dim(d: int) -> int:
    """The width the Hopper kernel stages a head dim at: whole 64-column
    swizzle atoms (80 -> 128; the columns past ``d`` are TMA's zero fill)."""
    return -(-d // 64) * 64


def sm90_flash_smem_bytes(block_q: int, block_k: int, d: int) -> int:
    """Dynamic shared memory of the Hopper kernel at these blocks, as its
    ``Cfg`` computes it: the Q tile, two stages of K and V tiles (bf16, at
    the padded head dim), 128 bytes of barriers and 1024 bytes of slack to
    align the tiles to the 1024-byte swizzle period."""
    return 2 * sm90_padded_head_dim(d) * (block_q + 2 * 2 * block_k) + 128 + 1024


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
        vmem = sm90_flash_smem_bytes(bq, bk, d)
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
