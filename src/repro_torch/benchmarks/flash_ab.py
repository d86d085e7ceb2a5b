"""Two builds of a bf16 kernel against each other on one card.

    PYTHONPATH=src python -m repro_torch.benchmarks.flash_ab --other DIR \
        [--kernel flash_attention|matmul] [--out build/flash_ab.json]

``DIR`` is the root of another checkout of the repository (a ``git archive``
of another commit, say, unpacked under ``build/``): its
``src/repro_torch/kernels/csrc/<kernel>.cu`` is compiled with this
checkout's nvcc flags into ``build/kernels/ab/``, and this checkout's
library is built as usual. Both are loaded side by side and called through
the entry point they share on the same bf16 inputs, at the blocks this
checkout's picker gives: ``flash_attention_fwd_bf16`` at the head dims
with instantiations of their own (64, 80 and 128), or ``matmul_bf16`` at
yi-6b's prefill products (the tuner's shapes):

- the outputs must be bit-equal (an unchanged instantiation computes the
  same function in the same order);
- each is timed by CUDA-graph replay (``measure.time_fn``) in turns,
  other, this, this, other, so that clock drift under the card's power
  limit falls on both alike; the ratio this/other is reported per case.

Prints one JSON line with the card's name and power limit, writes it to
``--out`` and exits 1 if an output differs. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.benchmarks.measure import time_fn
from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
from repro_torch.kernels import build, ops

# (B, Hq, Hkv, S, D, causal): yi-6b's heads, stablelm-3b's head dim 80 and
# whisper-large-v3's encoder (20/20 heads of 64 over its 1500 frames)
CASES = ((1, 32, 4, 1024, 128, True), (1, 32, 32, 1024, 80, True),
         (1, 20, 20, 1500, 64, False), (1, 8, 2, 1024, 64, True))


def _entry(lib: ctypes.CDLL):
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _matmul_entry(lib: ctypes.CDLL):
    fn = lib.matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_cases(gen, dev):
    """(the case's fields, its output, a call of a library's entry on it)."""
    for b, hq, hkv, s, d, causal in CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        blocks = ops.tuned_flash_blocks(s, d, 2)
        yield ({"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": causal,
                "blocks": list(blocks)}, torch.empty_like(q),
               lambda fn, o, q=q, k=k, v=v, blocks=blocks, causal=causal:
               _call(fn, q, k, v, o, blocks, causal))


def _matmul_cases(gen, dev):
    for m, n, k in YI6B_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        blocks = ops.tuned_matmul_blocks(m, n, k, 2)

        def run(fn, o, x=x, y=y, blocks=blocks):
            err = fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), *o.shape, x.shape[1],
                     *blocks[:3], int(blocks[3]), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"matmul_bf16 failed: cudaError_t {err}")

        yield ({"M": m, "N": n, "K": k, "blocks": list(blocks)},
               torch.empty((m, n), dtype=torch.bfloat16, device=dev), run)


# kernel source -> (its bf16 entry point, its cases)
KERNELS = {"flash_attention": (_entry, _flash_cases), "matmul": (_matmul_entry, _matmul_cases)}


def _call(fn, q, k, v, o, blocks, causal: bool) -> None:
    b, hq, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, k.shape[1], s,
             d, blocks[0], blocks[1], d ** -0.5, int(causal),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd_bf16 failed: cudaError_t {err}")


def build_other(root: Path, kernel: str = "flash_attention") -> Path:
    """The other checkout's library of ``kernel``, built with this
    checkout's flags."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{kernel}.cu"
    if not src.exists():
        raise SystemExit(f"no {kernel} source at {src}")
    out = build.BUILD_DIR / "ab" / f"{kernel}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernel", default="flash_attention", choices=sorted(KERNELS))
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs an NVIDIA card")
    dev = torch.device("cuda")
    entry, cases = KERNELS[args.kernel]
    libs = {"other": entry(ctypes.CDLL(str(build_other(Path(args.other), args.kernel)))),
            "this": entry(build.load(args.kernel))}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, differ = [], 0
    for fields, out, run in cases(gen, dev):
        outs = {name: torch.empty_like(out) for name in libs}
        for name, fn in libs.items():
            run(fn, outs[name])
        torch.cuda.synchronize()
        equal = bool(torch.equal(outs["other"], outs["this"]))
        differ += not equal
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn, o = libs[name], outs[name]
            times[name].append(time_fn(lambda: run(fn, o), dev, iters=args.iters,
                                       reps=10) * 1e3)
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        rows.append({**fields, "bit_equal": equal, "other_ms": ms["other"],
                     "this_ms": ms["this"], "ratio": ms["this"] / ms["other"],
                     "turns_ms": times})
        print(f"[flash_ab] {args.kernel} {fields}: other {ms['other']:.4f} ms "
              f"{times['other']}, this {ms['this']:.4f} ms {times['this']}, this/other "
              f"{ms['this'] / ms['other']:.4f}, bit-equal {equal}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps({"flash_ab": rows, "kernel": args.kernel, "card": card})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
