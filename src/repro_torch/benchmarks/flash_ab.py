"""Two builds of the bf16 flash kernel against each other on one card.

    PYTHONPATH=src python -m repro_torch.benchmarks.flash_ab --other DIR \
        [--out build/flash_ab.json]

``DIR`` is the root of another checkout of the repository (a ``git archive``
of another commit, say, unpacked under ``build/``): its
``src/repro_torch/kernels/csrc/flash_attention.cu`` is compiled with this
checkout's nvcc flags into ``build/kernels/ab/``, and this checkout's
library is built as usual. Both are loaded side by side and called through
the entry point they share, ``flash_attention_fwd_bf16``, on the same bf16
inputs at the head dims with instantiations of their own (64, 80 and 128)
and at the blocks this checkout's picker gives:

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


def _call(fn, q, k, v, o, blocks, causal: bool) -> None:
    b, hq, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, k.shape[1], s,
             d, blocks[0], blocks[1], d ** -0.5, int(causal),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd_bf16 failed: cudaError_t {err}")


def build_other(root: Path) -> Path:
    """The other checkout's flash library, built with this checkout's flags."""
    src = root / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    if not src.exists():
        raise SystemExit(f"no flash source at {src}")
    out = build.BUILD_DIR / "ab" / "flash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs an NVIDIA card")
    dev = torch.device("cuda")
    libs = {"other": _entry(ctypes.CDLL(str(build_other(Path(args.other))))),
            "this": _entry(build.load("flash_attention"))}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, differ = [], 0
    for b, hq, hkv, s, d, causal in CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        blocks = ops.tuned_flash_blocks(s, d, 2)
        outs = {name: torch.empty_like(q) for name in libs}
        for name, fn in libs.items():
            _call(fn, q, k, v, outs[name], blocks, causal)
        torch.cuda.synchronize()
        equal = bool(torch.equal(outs["other"], outs["this"]))
        differ += not equal
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn, o = libs[name], outs[name]
            times[name].append(time_fn(lambda: _call(fn, q, k, v, o, blocks, causal), dev,
                                       iters=args.iters, reps=10) * 1e3)
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        rows.append({"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": causal,
                     "blocks": list(blocks), "bit_equal": equal, "other_ms": ms["other"],
                     "this_ms": ms["this"], "ratio": ms["this"] / ms["other"],
                     "turns_ms": times})
        print(f"[flash_ab] D={d} Hq={hq} Hkv={hkv} S={s} causal={causal} blocks={blocks}: "
              f"other {ms['other']:.4f} ms {times['other']}, this {ms['this']:.4f} ms "
              f"{times['this']}, this/other {ms['this'] / ms['other']:.4f}, bit-equal "
              f"{equal}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps({"flash_ab": rows, "card": card})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
