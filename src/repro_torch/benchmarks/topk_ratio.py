"""Paper Fig. 3/4 on the H100: top-k performance ratio of Tuna's static
ranking against measured ground truth.

    ratio@k = Σ time(measured-best k configs) / Σ time(statically-best k)

(→ 1.0 means the static model picks schedules as good as measuring every
one on the card). The counterpart of the reference's
``benchmarks/topk_ratio.py``: the cost model scores the ``sm90`` matmul
space on the ``gpu_h100`` target with no card involved, then every
candidate runs through the hand-written Hopper kernel and is timed as
device time, by CUDA-graph replay (``measure.py``). When the space is no
larger than ``n_configs`` (the H100 space has at most 24 configs) all of it
is measured, so the oracle is the true measured optimum.

Three rankings of the same measured times:

  * static: the data-sheet ``cm1`` coefficients (the default);
  * calibrated (``calibrated=True``): the coefficients of the card's own
    probe fit (``core.calibrate``, cached under ``build/calibration/``). The
    reference's default is calibrated and silently falls back to data-sheet
    coefficients when its fit fails; here the option is explicit and a
    failed fit raises;
  * hybrid (``learned``): the static ranking's top ``rerank_top`` re-ordered
    by a learned ranker (``core.learned``), reported as ``hybrid_*`` keys
    beside the static ones. ``measured`` passes the times of an earlier
    call, so each ranking is scored on one set of times with no new launch.

``db`` writes the best static pick back to a schedule store (under
``cm1-cal-<fp>`` when calibrated, with ``-sample`` when the space was
sampled); ``collect`` also appends every measured (config, seconds) pair as
a ``cm1-meas`` record, the training set of ``python -m repro_torch.tuna
train``.

    python -m repro_torch.benchmarks.topk_ratio [--shape M N K]... [--calibrated]
        [--db F [--collect]] [--learned ARTIFACT [--check]] [--out F]

runs on the card (and raises without one) at the yi-6b projections of a
2048-token prefill by default, in bf16, or with ``--dtype-bytes 4`` in f32
(the f32 kernel at its built configurations, the space scored at 4 bytes);
``--device cpu`` times the plain version at small shapes, which exercises
the plumbing and measures nothing of the card.
``--check`` exits 1 unless the hybrid's mean ratio@k is at least the static
one's.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.measure import measure_config
from repro_torch.core.spaces import MatmulSpace
from repro_torch.core.tuner import _score_config, record_version
from repro_torch.hw import resolve_device
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.kernels import matmul as kmatmul

# (M, N, K) of every yi-6b projection for a 2048-token prefill (d_model 4096,
# 4 kv heads of 128, d_ff 11008), then the unembed (vocab 64000)
YI6B_SHAPES = ((2048, 4096, 4096), (2048, 512, 4096), (2048, 11008, 4096),
               (2048, 4096, 11008), (2048, 64000, 4096))
CPU_SHAPES = ((64, 128, 64), (128, 64, 128))


def sample_space(space, n: int, seed: int = 0,
                 limit: Optional[int] = None) -> List[Dict]:
    """Seeded random sample of ``n`` configs (the reference's sampler). The
    candidate pool is the whole space by default; an explicit ``limit``
    caps enumeration, and says so on stderr when it truncates."""
    size = space.size()
    cap = size if limit is None else min(limit, size)
    all_cfgs = list(space.enumerate(cap))
    if cap < size:
        print(f"[topk] {space.signature()}: enumeration truncated to "
              f"{cap} of {size} configs (limit={limit})", file=sys.stderr)
    rng = random.Random(seed)
    return all_cfgs if len(all_cfgs) <= n else rng.sample(all_cfgs, n)


def _tkey(cfg: Dict) -> Tuple:
    return tuple(sorted(cfg.items()))


def _rank_corr(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman's rank correlation (stable ranks) of two sequences."""
    if len(a) < 2:
        return 1.0
    ranks = [np.argsort(np.argsort(v, kind="stable"), kind="stable") for v in (a, b)]
    return float(np.corrcoef(*ranks)[0, 1])


def topk_ratio_matmul(M: int, N: int, K: int, n_configs: int = 128,
                      ks: Sequence[int] = (1, 5, 10), iters: int = 10,
                      seed: int = 0, device="cuda", calibrated: bool = False,
                      db=None, limit: Optional[int] = None, learned=None,
                      rerank_top: int = 12, collect: bool = False,
                      measured: Optional[Sequence[Dict]] = None,
                      dtype_bytes: int = 2) -> Dict:
    """Static ranking vs measured times over the Hopper matmul space at
    (M, N, K), bf16, or f32 with ``dtype_bytes=4`` (the space at 4 bytes,
    the configurations the f32 kernel is built for). Returns ``ratio@k`` for each k, ``top1_ratio``,
    ``best_static_ms``, ``best_oracle_ms``, ``static_s``, ``measure_s``,
    ``n_configs``, ``space_size``, ``sample_truncated``, ``rank_corr``
    (Spearman's rank correlation of static score and measured time over the
    measured configs) and ``ranking``: every measured config with its
    static score and measured ms, in static order.

    ``calibrated`` scores with the card's cached probe fit (fitting it
    first when there is none; ``coeffs_version`` names the lineage).
    ``learned`` (a ``LearnedRanker`` or an artifact path) adds
    ``hybrid_ratio@k``, ``hybrid_top1_ratio``, ``hybrid_rank_corr`` (of
    hybrid position and measured time), ``hybrid_ranking`` (the configs in
    hybrid order), ``hybrid_s`` and ``learned_version``. ``measured`` (an
    earlier call's ``ranking``) ranks those configs on those times instead
    of measuring (they must be this call's sample: the same ``n_configs``,
    ``seed`` and ``limit``). ``db`` and ``collect`` write to a store (module
    docstring); ``collect`` needs a measuring call."""
    dev = resolve_device(device)
    if collect and (db is None or measured is not None):
        raise ValueError("collect needs a db and a call that measures")
    if db is not None:  # None stays off (no default-DB pull)
        from repro_torch.core.tuner import resolve_db

        db = resolve_db(db)
    if learned is not None:
        from repro_torch.core.tuner import resolve_learned

        learned = resolve_learned(learned)
    coeffs = None
    if calibrated:
        from repro_torch.core.calibrate import cached_coeffs, coeffs_for_scoring

        coeffs = coeffs_for_scoring(cached_coeffs(GPU_H100.name, dev))
    dtype = {2: torch.bfloat16, 4: torch.float32}[dtype_bytes]
    space = MatmulSpace(M, N, K, dtype_bytes, target_kind=GPU_H100.kind)
    cfgs = [c for c in sample_space(space, n_configs, seed, limit=limit)
            if kmatmul.built(c["bm"], c["bn"], c["bk"], c["double_buffer"], dtype)]
    if not cfgs:
        raise ValueError(f"{space.signature()}: no built tile divides the shape")
    if measured is not None and sorted(map(_tkey, cfgs)) != sorted(
            _tkey(e["config"]) for e in measured):
        raise ValueError(f"{space.signature()}: the measured configs are not "
                         f"this call's sample")

    t0 = time.perf_counter()
    scores = [(cfg, _score_config(space, GPU_H100, cfg, coeffs)) for cfg in cfgs]
    static_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if measured is not None:
        times = {_tkey(e["config"]): e["ms"] / 1e3 for e in measured}
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
        times = {_tkey(cfg): measure_config(a, b, cfg, iters=iters)
                 for cfg, _ in scores}
    measure_s = time.perf_counter() - t0

    by_static = sorted(scores, key=lambda cs: cs[1])
    by_measured = sorted(scores, key=lambda cs: times[_tkey(cs[0])])
    out = {"static_s": static_s, "measure_s": measure_s,
           "n_configs": len(cfgs), "space_size": space.size(),
           "sample_truncated": limit is not None and limit < space.size()}
    if coeffs is not None:
        out["coeffs_version"] = record_version(coeffs)
    by_hybrid = None
    if learned is not None:
        t0 = time.perf_counter()
        by_hybrid = learned.rerank(space, GPU_H100, by_static, top=rerank_top)
        out["hybrid_s"] = time.perf_counter() - t0
        out["learned_version"] = learned.version
    for k in ks:
        k = min(k, len(cfgs))
        t_oracle = sum(times[_tkey(c)] for c, _ in by_measured[:k])
        out[f"ratio@{k}"] = t_oracle / sum(times[_tkey(c)] for c, _ in by_static[:k])
        if by_hybrid is not None:
            out[f"hybrid_ratio@{k}"] = t_oracle / sum(
                times[_tkey(c)] for c, _ in by_hybrid[:k])
    best_static = times[_tkey(by_static[0][0])]
    best_oracle = times[_tkey(by_measured[0][0])]
    out["top1_ratio"] = best_oracle / best_static
    out["best_static_ms"] = best_static * 1e3
    out["best_oracle_ms"] = best_oracle * 1e3
    out["rank_corr"] = _rank_corr([s for _, s in scores],
                                  [times[_tkey(c)] for c, _ in scores])
    out["ranking"] = [{"config": c, "score": s, "ms": times[_tkey(c)] * 1e3}
                      for c, s in by_static]
    if by_hybrid is not None:
        out["hybrid_top1_ratio"] = best_oracle / times[_tkey(by_hybrid[0][0])]
        out["hybrid_rank_corr"] = _rank_corr(
            list(range(len(by_hybrid))), [times[_tkey(c)] for c, _ in by_hybrid])
        out["hybrid_ranking"] = [c for c, _ in by_hybrid]

    if db is not None:
        from repro_torch.tuna.db import ScheduleRecord, stamp_tuned_at

        version = record_version(coeffs)
        if len(cfgs) < space.size():
            # best of a sample, not the space optimum: never to be warm-hit
            # as if it were a search-grade record
            version += "-sample"
        warm = db.best(space.signature(), GPU_H100.name, version=version)
        if warm is not None:
            out["warm_config"] = dict(warm.config)
        db.add(ScheduleRecord(
            op=space.signature(), target=GPU_H100.name,
            config=dict(by_static[0][0]), score=by_static[0][1],
            evaluations=len(cfgs),
            meta={"strategy": "topk_static", "measured_ms": best_static * 1e3,
                  "oracle_ms": best_oracle * 1e3},
            version=version,
        ))
        if collect:
            from repro_torch.core.learned import measured_version

            for cfg, _ in scores:
                # one key for all samples: the index keeps the fastest, the
                # append-only log every (config, seconds) pair, which is
                # what the trainer reads
                db.add(ScheduleRecord(
                    op=space.signature(), target=GPU_H100.name,
                    config=dict(cfg), score=times[_tkey(cfg)],
                    evaluations=iters,
                    meta=stamp_tuned_at({"strategy": "measured_sample",
                                         "iters": iters}),
                    version=measured_version(),
                ))
            out["collected"] = len(scores)
    return out


def _summary(res: Dict, prefix: str = "") -> Dict:
    k = min(5, res["n_configs"])
    return {"top1": res[f"{prefix}top1_ratio"], f"ratio@{k}": res[f"{prefix}ratio@{k}"],
            "rank_corr": res[f"{prefix}rank_corr"]}


def three_way(measured: Dict[Tuple[int, int, int], Dict], store, work_dir,
              device="cuda", rerank_top: int = 12) -> Tuple[Dict[str, Dict], Dict]:
    """Rank each shape's measured times (``measured``: shape -> a measuring
    call's result) three ways, on those times and with no launch: static,
    calibrated (the card's cached fit) and hybrid. Returns per shape the
    ``top1``, ``ratio@5`` and ``rank_corr`` of each ranking with the
    lineages that made them, and ``check_hybrid`` over the shapes. Each shape's hybrid
    ranker is trained by ``train_from_store`` on the ``cm1-meas`` rows of
    ``store`` (a path) whose op is not that shape's, written to a store of
    their own under ``work_dir``, and round-trips through
    ``save_ranker``/``load_ranker`` before it ranks. Raises
    ``AssertionError`` when a training group holds the scored shape, an
    artifact does not round-trip or a ranking is not a permutation of the
    measured configs."""
    from pathlib import Path

    from repro_torch.core.learned import load_ranker, measured_version, save_ranker
    from repro_torch.tuna.db import ScheduleDatabase
    from repro_torch.tuna.learned import (build_dataset, iter_log_records,
                                          train_from_store, training_rows)

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    rows = [r for r in iter_log_records(store) if r.version == measured_version()]
    out, hybrid = {}, {}
    for (m, n, k), res in measured.items():
        name = f"{m}x{n}x{k}"
        sig = MatmulSpace(m, n, k, 2, target_kind=GPU_H100.kind).signature()
        loo_path = work / f"loo-{name}.jsonl"
        loo_path.unlink(missing_ok=True)
        loo = ScheduleDatabase(str(loo_path))
        for r in rows:
            if r.op != sig:
                loo.add(r)
        _, _, groups, _ = build_dataset(training_rows(iter_log_records(str(loo_path))))
        assert groups and not any(g.split("@")[1] == sig for g in groups), \
            f"{name}: the hybrid's training groups hold the shape it scores"
        model, _, n_rows, _ = train_from_store(str(loo_path))
        art = work / f"learned-{name}.json"
        save_ranker(model, str(art))
        loaded = load_ranker(str(art))
        assert loaded.fingerprint() == model.fingerprint() and \
            loaded.version == model.version, f"{name}: the artifact did not round-trip"
        kw = dict(ks=(1, 5), device=device, measured=res["ranking"])
        cal = topk_ratio_matmul(m, n, k, calibrated=True, **kw)
        hyb = topk_ratio_matmul(m, n, k, learned=loaded, rerank_top=rerank_top, **kw)
        want = sorted(map(_tkey, (e["config"] for e in res["ranking"])))
        for what, order in (("static", [e["config"] for e in hyb["ranking"]]),
                            ("calibrated", [e["config"] for e in cal["ranking"]]),
                            ("hybrid", hyb["hybrid_ranking"])):
            assert sorted(map(_tkey, order)) == want, \
                f"{name}: the {what} ranking is not a permutation of the measured configs"
        out[name] = {
            "static": _summary(hyb), "calibrated": _summary(cal),
            "hybrid": _summary(hyb, "hybrid_"),
            "coeffs_version": cal["coeffs_version"],
            "learned_version": hyb["learned_version"], "train_rows": n_rows,
            "train_ops": sorted({g.split("@")[1] for g in groups})}
        hybrid[name] = hyb
    return out, check_hybrid(hybrid)


def mean_ratios(results: Dict[str, Dict], prefix: str) -> Optional[float]:
    """Mean of every ``<prefix>@k`` value over the results (``ratio`` or
    ``hybrid_ratio``); None when there is none."""
    vals = [v for res in results.values() for key, v in res.items()
            if key.startswith(prefix + "@")]
    return sum(vals) / len(vals) if vals else None


def check_hybrid(results: Dict[str, Dict]) -> Dict:
    """``--check``: the hybrid's mean ratio@k is at least the static one's.
    Both rank one table of times, so equal top-k sets give equal ratios;
    the epsilon only absorbs the order of summation."""
    static, hybrid = mean_ratios(results, "ratio"), mean_ratios(results, "hybrid_ratio")
    ok = hybrid is not None and hybrid >= static - 1e-9
    return {"ok": ok, "static_mean_ratio": static, "hybrid_mean_ratio": hybrid,
            "gate": "hybrid_mean >= static_mean"}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="top-k performance ratio of the static matmul ranking "
                    "against times measured on the card, optionally "
                    "calibrated and beside the hybrid learned ranking")
    p.add_argument("--shape", nargs=3, type=int, action="append",
                   metavar=("M", "N", "K"),
                   help="matmul shape (repeatable); default: the yi-6b "
                        "prefill projections on cuda, two small shapes on cpu")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None,
                   help="cap the enumerated candidate pool")
    p.add_argument("--calibrated", action="store_true",
                   help="score with the card's probe fit (build/calibration)")
    p.add_argument("--db", default=None,
                   help="schedule store to write winners (and --collect "
                        "samples) into")
    p.add_argument("--collect", action="store_true",
                   help="append every per-config measurement to --db under "
                        "the cm1-meas lineage (training data)")
    p.add_argument("--learned", default=None, metavar="ARTIFACT",
                   help="learned-ranker artifact (or latest pointer): "
                        "report the hybrid ranking side by side")
    p.add_argument("--rerank-top", type=int, default=12)
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless the mean hybrid ratio@k >= the mean "
                        "static ratio@k (requires --learned)")
    p.add_argument("--dtype-bytes", type=int, default=2, choices=(2, 4),
                   help="2: bf16 (the default); 4: f32")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    args = p.parse_args(argv)
    if args.collect and not args.db:
        p.error("--collect requires --db")
    if args.check and not args.learned:
        p.error("--check requires --learned")
    dev = resolve_device(args.device)
    shapes = [tuple(s) for s in args.shape] if args.shape else (
        YI6B_SHAPES if dev.type == "cuda" else CPU_SHAPES)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    learned = None
    if args.learned:
        from repro_torch.core.tuner import resolve_learned

        learned = resolve_learned(args.learned)  # verified load, once
    results = {}
    for m, n, k in shapes:
        res = topk_ratio_matmul(m, n, k, iters=args.iters, seed=args.seed,
                                device=dev, calibrated=args.calibrated,
                                db=args.db, limit=args.limit, learned=learned,
                                rerank_top=args.rerank_top, collect=args.collect,
                                dtype_bytes=args.dtype_bytes)
        results[f"{m}x{n}x{k}"] = res
        pairs = ", ".join(f"{key}={v:.4f}" for key, v in res.items()
                          if key.startswith(("ratio@", "top1", "best_", "rank_",
                                             "hybrid_ratio@", "hybrid_top1",
                                             "hybrid_rank_corr")))
        print(f"{m}x{n}x{k} on {where}: {pairs}, static {res['static_s']:.3f} s, "
              f"measured {res['n_configs']}/{res['space_size']} configs in "
              f"{res['measure_s']:.3f} s", flush=True)
    summary = {"device": where, "dtype_bytes": args.dtype_bytes, "results": results,
               "static_mean_ratio": mean_ratios(results, "ratio"),
               "hybrid_mean_ratio": mean_ratios(results, "hybrid_ratio")}
    if args.check:
        summary["check"] = check_hybrid(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if args.check:
        if not summary["check"]["ok"]:
            print(f"CHECK FAILED: hybrid mean ratio "
                  f"{summary['hybrid_mean_ratio']} < static mean ratio "
                  f"{summary['static_mean_ratio']}", file=sys.stderr)
            return 1
        print("CHECK OK: hybrid >= static")
    return 0


if __name__ == "__main__":
    sys.exit(main())
