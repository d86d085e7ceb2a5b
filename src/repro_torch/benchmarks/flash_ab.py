"""Two builds of a kernel against each other on one card.

    PYTHONPATH=src python -m repro_torch.benchmarks.flash_ab --other DIR \
        [--kernel flash_attention|matmul] [--dtype bfloat16|float32] \
        [--define NAME=VALUE]... [--out build/flash_ab.json]

``DIR`` is the root of another checkout of the repository (a ``git archive``
of another commit, say, unpacked under ``build/``): its
``src/repro_torch/kernels/csrc/<kernel>.cu`` is compiled with this
checkout's nvcc flags (and any ``--define NAME=VALUE``) into
``build/kernels/ab/``, and this checkout's library is built as usual. Both are loaded side by side and called through
the entry point they share on the same inputs, at the blocks this
checkout's picker gives.

In bf16 (the default): ``flash_attention_fwd_bf16`` at the head dims with
instantiations of their own (64, 80 and 128), or ``matmul_bf16`` at
yi-6b's prefill products (the tuner's shapes):

- the outputs must be bit-equal (an unchanged instantiation computes the
  same function in the same order); each output's sha1 is reported
  (``digests``), so that a run of one build alone can be held to another's
  (the smoke holds this checkout's bf16 builds to the digests of the
  commit before its f16 and wide builds were added);
- each is timed by CUDA-graph replay (``measure.time_fn``) in turns,
  other, this, this, other, so that clock drift under the card's power
  limit falls on both alike; the ratio this/other is reported per case.

In f32 (``--dtype float32``): ``flash_attention_fwd_f32`` at the smoke's
f32 grid (the reference's flash grid, causal and not, yi-6b's heads at
S=1024 and the reduced configs' shape) or ``matmul_f32`` at its matmul
shapes, two builds that need not be bit-equal (two designs of the f32
kernels, say): each output's max |error| against an f64 oracle on the same
inputs and its worst share of the reference's f32 limit (flash atol 3e-5,
rtol 3e-4; matmul atol 2e-4 sqrt(K), rtol 2e-4) are reported beside the
times in turns, and the run fails if this checkout's output is outside the
limit anywhere.

The inputs are drawn from numpy (seed 0), so the same cases come out on
any card and torch version. Prints one JSON line with the card's name and
power limit, writes it to ``--out`` and exits 1 if a bf16 output differs
(or an f32 one is outside the limit). Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.measure import time_fn
from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
from repro_torch.kernels import build, ops, ref

# (B, Hq, Hkv, S, D, causal): yi-6b's heads, stablelm-3b's head dim 80 and
# whisper-large-v3's encoder (20/20 heads of 64 over its 1500 frames)
CASES = ((1, 32, 4, 1024, 128, True), (1, 32, 32, 1024, 80, True),
         (1, 20, 20, 1500, 64, False), (1, 8, 2, 1024, 64, True))
# f32: the smoke's grid (the reference's TestFlashAttentionKernel, causal and
# not), yi-6b's heads at S=1024, the reduced configs' shape (train_tiny's
# 8 x 64 tokens, 4/2 heads of 16), 32/4 heads of 192 and 256 at S=1024 (the
# kernel of 64-column K/V chunks) and 8/2 of 256 at S=4096, where P V sums
# 64 key tiles into one accumulator; its matmul shapes (the reference's
# TestMatmulKernel, dense_256/512), the one it times, and two long K (yi-6b's
# 11008 and 16384), where the tensor cores' accumulation error shows
F32_CASES = tuple((b, hq, hkv, s, d, c) for b, hq, hkv, s, d in (
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 32), (2, 4, 4, 512, 128))
    for c in (True, False)) + ((1, 32, 4, 1024, 128, True), (8, 4, 2, 64, 16, True),
                               (1, 32, 4, 1024, 192, True), (1, 32, 4, 1024, 256, True),
                               (1, 8, 2, 4096, 256, True))
F32_MM_SHAPES = ((128, 128, 128), (256, 128, 512), (64, 256, 128), (384, 256, 256),
                 (256, 256, 256), (512, 512, 512), (2048, 4096, 4096),
                 (2048, 4096, 11008), (1024, 1024, 16384))
# the reference's f32 limits: flash (atol, rtol); matmul rtol, atol rtol*sqrt(K)
F32_FLASH_LIMIT, F32_MM_TOL = (3e-5, 3e-4), 2e-4
ENTRY = {("flash_attention", torch.bfloat16): "flash_attention_fwd_bf16",
         ("flash_attention", torch.float32): "flash_attention_fwd_f32",
         ("matmul", torch.bfloat16): "matmul_bf16",
         ("matmul", torch.float32): "matmul_f32"}


def _entry(lib: ctypes.CDLL, name: str = "flash_attention_fwd_bf16"):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _matmul_entry(lib: ctypes.CDLL, name: str = "matmul_bf16"):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _randn(rng, shape, dev, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)


def _flash_cases(rng, dev, dtype=torch.bfloat16):
    """(the case's fields, its output, a call of a library's entry on it,
    the f64 oracle's output and the reference's limit: (atol, rtol))."""
    for b, hq, hkv, s, d, causal in (CASES if dtype == torch.bfloat16 else F32_CASES):
        q, k, v = (_randn(rng, shape, dev, dtype)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        blocks = ops.tuned_flash_blocks(s, d, q.element_size())
        yield ({"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": causal,
                "blocks": list(blocks)}, torch.empty_like(q),
               lambda fn, o, q=q, k=k, v=v, blocks=blocks, causal=causal:
               _call(fn, q, k, v, o, blocks, causal),
               lambda q=q, k=k, v=v, causal=causal: ref.attention(
                   q.double(), k.double(), v.double(), causal=causal),
               F32_FLASH_LIMIT)


def _matmul_cases(rng, dev, dtype=torch.bfloat16):
    for m, n, k in (YI6B_SHAPES if dtype == torch.bfloat16 else F32_MM_SHAPES):
        x, y = _randn(rng, (m, k), dev, dtype), _randn(rng, (k, n), dev, dtype)
        blocks = ops.tuned_matmul_blocks(m, n, k, x.element_size())

        def run(fn, o, x=x, y=y, blocks=blocks):
            err = fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), *o.shape, x.shape[1],
                     *blocks[:3], int(blocks[3]), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"matmul failed: cudaError_t {err}")

        yield ({"M": m, "N": n, "K": k, "blocks": list(blocks)},
               torch.empty((m, n), dtype=dtype, device=dev), run,
               lambda x=x, y=y: x.double() @ y.double(), (F32_MM_TOL * k ** 0.5, F32_MM_TOL))


# kernel source -> (its entry point, its cases)
KERNELS = {"flash_attention": (_entry, _flash_cases), "matmul": (_matmul_entry, _matmul_cases)}


def _call(fn, q, k, v, o, blocks, causal: bool) -> None:
    b, hq, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, k.shape[1], s,
             d, blocks[0], blocks[1], d ** -0.5, int(causal),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention failed: cudaError_t {err}")


def _sha1(t: torch.Tensor) -> str:
    """The sha1 of the output's bytes."""
    word = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return hashlib.sha1(t.cpu().view(word).numpy().tobytes()).hexdigest()


def _error(got: torch.Tensor, want: torch.Tensor, limit) -> Dict[str, float]:
    """max |got - want| and its worst share of atol + rtol*|want|."""
    atol, rtol = limit
    err = (got.double() - want).abs()
    return {"max_abs_err": float(err.max()),
            "of_limit": float((err / (atol + rtol * want.abs())).max())}


def digests(kernel: str, lib: ctypes.CDLL) -> Dict[str, str]:
    """The sha1 of each case's output through ``lib``'s bf16 entry, keyed by
    the case's fields (as JSON): what two builds that are bit-equal share."""
    entry, cases = KERNELS[kernel]
    fn, dev, out = entry(lib), torch.device("cuda"), {}
    for fields, o, run, _, _ in cases(np.random.default_rng(0), dev):
        run(fn, o)
        torch.cuda.synchronize()
        out[json.dumps(fields, sort_keys=True)] = _sha1(o)
    return out


def build_other(root: Path, kernel: str = "flash_attention", defines=()) -> Path:
    """The other checkout's library of ``kernel``, built with this
    checkout's flags and ``defines`` (``NAME=VALUE`` each)."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{kernel}.cu"
    if not src.exists():
        raise SystemExit(f"no {kernel} source at {src}")
    out = build.BUILD_DIR / "ab" / f"{kernel}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                          "-o", str(out), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernel", default="flash_attention", choices=sorted(KERNELS))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--define", action="append", default=[], metavar="NAME=VALUE",
                    help="a preprocessor define for the other build (repeatable): the "
                         "same sources built another way, e.g. --other . --define "
                         "MM_F32_FLUSH_SLOTS=1048576")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f64 oracle is exact anyway
    dev, dtype = torch.device("cuda"), getattr(torch, args.dtype)
    entry, cases = KERNELS[args.kernel]
    name = ENTRY[args.kernel, dtype]
    libs = {"other": entry(ctypes.CDLL(str(build_other(Path(args.other), args.kernel,
                                                       args.define))), name),
            "this": entry(build.load(args.kernel), name)}
    rows, bad = [], 0
    for fields, out, run, oracle, limit in cases(np.random.default_rng(0), dev, dtype):
        outs = {who: torch.empty_like(out) for who in libs}
        for who, fn in libs.items():
            run(fn, outs[who])
        torch.cuda.synchronize()
        equal = bool(torch.equal(outs["other"], outs["this"]))
        row = {**fields, "bit_equal": equal, "sha1": _sha1(outs["this"]),
               "other_sha1": _sha1(outs["other"])}
        if dtype == torch.float32:
            want = oracle()
            row["error"] = {who: _error(o, want, limit) for who, o in outs.items()}
            bad += row["error"]["this"]["of_limit"] > 1
            del want
        else:
            bad += not equal
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            fn, o = libs[who], outs[who]
            times[who].append(time_fn(lambda: run(fn, o), dev, iters=args.iters,
                                      reps=10) * 1e3)
        ms = {who: sum(t) / len(t) for who, t in times.items()}
        row.update(other_ms=ms["other"], this_ms=ms["this"],
                   ratio=ms["this"] / ms["other"], turns_ms=times)
        rows.append(row)
        print(f"[flash_ab] {args.kernel} {args.dtype} {fields}: other {ms['other']:.4f} ms "
              f"{times['other']}, this {ms['this']:.4f} ms {times['this']}, this/other "
              f"{ms['this'] / ms['other']:.4f}, bit-equal {equal}"
              + (f", vs the f64 oracle {row['error']}" if "error" in row else ""), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps({"flash_ab": rows, "kernel": args.kernel, "dtype": args.dtype,
                       "other_defines": args.define, "card": card})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
