"""``python -m repro_torch.tuna`` — operate the persistent schedule database.

The port's own copy of ``repro.tuna.cli``, with the same exit codes (2 for
a bad op, target or flag, 1 for a query miss or a failed job, 0 for
success). It is static: it scores schedules with the cost model and reads
no device, as the paper's compilation service does.

Subcommands:
  tune     fan (ops × targets) jobs across a worker pool into the DB;
           --num-shards/--shard-id take one deterministic slice of the
           matrix into a per-shard store (the fleet write path);
           --transport pushes the finished store into a channel
  sync     merge per-shard stores back into the base store (+ provenance);
           --transport pulls shard stores from a channel (verified) first;
           --verify fails on any divergence from a reference store and on
           any corrupt/torn source line dropped during the merge
  snapshot compile the store into an immutable serving cache (JSON + sha1);
           --dir keeps a versioned snapshot + `latest` pointer lifecycle;
           --publish pushes the artifact over a transport
  query    print best records (filter by --op prefix / --target /
           --version; --snapshot reads a compiled cache instead of the DB —
           a stale-version snapshot is an error unless --allow-stale;
           --json emits one array)
  compact  rewrite the log keeping only the best record per key;
           --transport pulls the fleet's shard stores first (then pushes
           the compacted store back); bare per-shard siblings on disk are
           a fail-fast error unless --ignore-shards
  export   dump best records as a JSON array (same --transport/shard
           discipline as compact)
  golden   freeze the store's best records for one target into a
           regression-gated golden release (--waive OP[@TARGET] accepts a
           regression, recorded in the release); --bundle adds a kernel
           bundle with the compiled Hopper libraries (--device cpu: a
           bundle of plain-version entries, no nvcc); --publish pushes
           release and bundle over a transport. Exit 1 when the gate
           refuses, 2 when there is nothing to promote

The reference's controller, train and eval subcommands wait for ROADMAP
Queue A 9.

``--db`` defaults to ``$REPRO_TUNA_DB``; without either it is required.

Transports (see repro_torch.tuna.transport): dir:///path (or a bare path)
is a directory bucket; mem://name is the in-process test channel.

Examples:
  python -m repro_torch.tuna tune --smoke --db db.jsonl
  python -m repro_torch.tuna snapshot --db db.jsonl --out cache.json
  python -m repro_torch.tuna query --db db.jsonl --op flash --target gpu_h100
  python -m repro_torch.tuna snapshot --db db.jsonl --dir snapshots/
  python -m repro_torch.tuna query --snapshot snapshots/schedule_cache.latest.json
  python -m repro_torch.tuna golden --db db.jsonl --bundle --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.configs.tuna_ops import OPERATORS, SMOKE_OPERATORS
from repro_torch.hw import TARGET_NAMES
from repro_torch.tuna import orchestrator
from repro_torch.tuna.db import ScheduleDatabase

DEFAULT_TARGETS = ",".join(TARGET_NAMES)


def _add_db(p: argparse.ArgumentParser, help: Optional[str] = None,
            required: bool = True) -> None:
    """``--db``: defaults to ``$REPRO_TUNA_DB`` (read when the parser is
    built), required without it."""
    env = os.environ.get("REPRO_TUNA_DB") or None
    p.add_argument("--db", default=env, required=required and env is None,
                   help=help)


def _csv(s: str) -> List[str]:
    return [x for x in (p.strip() for p in s.split(",")) if x]


def cmd_tune(args: argparse.Namespace) -> int:
    if args.smoke:
        ops = list(SMOKE_OPERATORS)
        targets = list(TARGET_NAMES)
        workers = min(args.workers, 2)
        limit = min(args.limit, 256)
    else:
        ops = _csv(args.ops) if args.ops != "all" else list(OPERATORS)
        targets = _csv(args.targets)
        workers, limit = args.workers, args.limit
    for op in ops:
        if op not in OPERATORS:
            print(f"error: unknown operator {op!r}; have {sorted(OPERATORS)}",
                  file=sys.stderr)
            return 2
    for t in targets:
        if t not in TARGET_NAMES:
            print(f"error: unknown target {t!r}; have {sorted(TARGET_NAMES)}",
                  file=sys.stderr)
            return 2
    jobs = orchestrator.jobs_for(ops, targets, strategy=args.strategy,
                                 limit=limit, seed=args.seed)
    db_path = args.db
    if args.num_shards < 1:
        print("error: --num-shards must be >= 1", file=sys.stderr)
        return 2
    if not 0 <= args.shard_id < args.num_shards:
        print(f"error: --shard-id must be in [0, {args.num_shards})",
              file=sys.stderr)
        return 2
    if args.num_shards > 1:
        from repro_torch.tuna import fleet

        jobs = fleet.shard_jobs(jobs, args.num_shards, args.shard_id)
        # even an empty shard leaves a store file so sync can tell
        # "finished with no jobs" apart from "crashed"
        db_path = fleet.touch_store(
            fleet.shard_store_path(args.db, args.shard_id))
        print(f"[tuna] shard {args.shard_id}/{args.num_shards}: "
              f"{len(jobs)} jobs -> {db_path}")
    db = ScheduleDatabase(db_path)
    report = orchestrator.run(jobs, db=db, workers=workers,
                              retries=args.retries, verbose=True)
    print(f"[tuna] {len(report.records)}/{len(jobs)} jobs done in "
          f"{report.wall_seconds:.1f}s -> {db_path} ({len(db)} keys)")
    for fail in report.failures:
        print(f"[tuna] FAILED {fail.job.op} @ {fail.job.target} after "
              f"{fail.attempts} attempts:\n{fail.error}", file=sys.stderr)
    if args.transport:
        from repro_torch.tuna import fleet
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(args.transport)
        # always push under the shard object name (shard 0 for an
        # unsharded run): `sync --transport` only ever pulls shard names,
        # so a base-named push would be unreachable
        man = t.push(db_path, fleet.shard_object_name(args.db, args.shard_id))
        print(f"[tuna] pushed {man.name} ({man.records} records, "
              f"sha1 {man.sha1[:12]}) -> {t.describe()}")
    return 0 if report.ok else 1


def cmd_sync(args: argparse.Namespace) -> int:
    from repro_torch.tuna import fleet

    rep = fleet.sync(args.db, args.num_shards,
                     provenance=not args.no_provenance,
                     compact=not args.no_compact,
                     transport=args.transport or None,
                     staging_dir=args.staging_dir)
    for name in rep.pulled:
        print(f"[tuna] pulled {name} (verified)")
    for path, n in rep.absorbed.items():
        print(f"[tuna] {path}: absorbed {n} records")
    for path in rep.skipped:
        print(f"[tuna] missing shard store {path} (skipped; re-run sync "
              f"after the shard finishes)", file=sys.stderr)
    if rep.corrupt_lines:
        print(f"[tuna] WARNING: dropped {rep.corrupt_lines} corrupt/torn "
              f"source line(s) during merge "
              f"({ {p: n for p, n in rep.corrupt.items() if n} }); "
              f"re-run sync once the shard writers finish", file=sys.stderr)
    print(f"[tuna] synced {args.db}: {rep.keys} keys from "
          f"{args.num_shards - len(rep.skipped)}/{args.num_shards} shards")
    if args.verify:
        ref = ScheduleDatabase(args.verify)
        div = fleet.divergence(rep.db, ref, label_a=args.db,
                               label_b=args.verify)
        if div:
            print("[tuna] MERGE DIVERGENCE:", file=sys.stderr)
            for msg in div:
                print(f"  {msg}", file=sys.stderr)
            return 1
        if rep.corrupt_lines:
            print("[tuna] --verify: corrupt source lines were dropped — "
                  "the merge is not lossless, failing", file=sys.stderr)
            return 1
        print(f"[tuna] verified against {args.verify}: no divergence")
    return 0


def cmd_snapshot(args: argparse.Namespace) -> int:
    from repro_torch.tuna.cache import ScheduleCache, SnapshotManager

    if args.dir:
        mgr = SnapshotManager(args.db, args.dir)
        info = mgr.ensure(force=args.force)
        state = "rebuilt" if info.rebuilt else "up to date"
        print(f"[tuna] snapshot {info.path}: {info.count} records ({state}; "
              f"latest -> {info.name})")
        if args.publish:
            from repro_torch.tuna.transport import resolve_transport

            t = resolve_transport(args.publish)
            for man in mgr.publish(t, info=info):
                print(f"[tuna] published {man.name} ({man.size}B, "
                      f"sha1 {man.sha1[:12]}) -> {t.describe()}")
        return 0
    if not args.out:
        print("error: snapshot needs --out FILE or --dir OUT_DIR",
              file=sys.stderr)
        return 2
    cache = ScheduleCache.build(args.db, args.out)
    print(f"[tuna] snapshot {args.out}: {len(cache)} records from {args.db}")
    if args.publish:
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(args.publish)
        man = t.push(args.out)
        print(f"[tuna] published {man.name} ({man.records} records, "
              f"sha1 {man.sha1[:12]}) -> {t.describe()}")
    return 0


def cmd_query(args: argparse.Namespace) -> int:
    if args.snapshot:
        from repro_torch.tuna.cache import ScheduleCache, StaleSnapshotError

        try:
            store = ScheduleCache.load(args.snapshot,
                                       allow_stale=args.allow_stale)
        except StaleSnapshotError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if store.stale:
            print(f"[tuna] WARNING: serving a stale snapshot (built for "
                  f"cost-model version {store.cost_model_version!r})",
                  file=sys.stderr)
    elif args.db:
        store = ScheduleDatabase(args.db)
    else:
        print("error: query needs --db FILE or --snapshot FILE",
              file=sys.stderr)
        return 2
    from repro_torch.tuna.db import record_to_dict

    recs = store.query(op=args.op, target=args.target, version=args.version)
    if args.json:
        # one serializer (db.record_to_dict) for query and export
        print(json.dumps([record_to_dict(r) for r in recs], indent=2,
                         sort_keys=True, default=float))
        return 0 if recs else 1
    if not recs:
        print("no matching records", file=sys.stderr)
        return 1
    for rec in recs:
        print(json.dumps(record_to_dict(rec), sort_keys=True, default=float))
    return 0


def _shard_siblings(db_path: str) -> List[str]:
    """Per-shard stores sitting next to a base store on disk
    (``db.jsonl`` -> ``db.shardNN.jsonl``), the layout ``tune
    --num-shards`` writes."""
    import glob

    root, ext = os.path.splitext(os.fspath(db_path))
    return sorted(glob.glob(f"{root}.shard[0-9][0-9]{ext or '.jsonl'}"))


def _pull_fleet_or_fail(args: argparse.Namespace, cmd: str) -> int:
    """Whole-store guard shared by compact/export: both commands claim to
    operate on *the* store, so running them against the base file while a
    fleet publishes per-shard stores silently works on a stale partial
    copy. With --transport, pull + merge every published shard first
    (sync's verified path); otherwise refuse when shard siblings exist on
    disk, unless the operator says --ignore-shards."""
    if args.transport:
        if not args.num_shards:
            print(f"error: {cmd} --transport needs --num-shards to know "
                  f"which shard stores to pull", file=sys.stderr)
            return 2
        from repro_torch.tuna import fleet

        rep = fleet.sync(args.db, args.num_shards, compact=False,
                         transport=args.transport,
                         staging_dir=args.staging_dir)
        for name in rep.pulled:
            print(f"[tuna] pulled {name} (verified)")
        for path in rep.skipped:
            print(f"[tuna] WARNING: shard store {path} not published yet "
                  f"(skipped) — the {cmd} covers a partial fleet",
                  file=sys.stderr)
        return 0
    shards = _shard_siblings(args.db)
    if shards and not args.ignore_shards:
        print(f"error: {args.db} has {len(shards)} per-shard store(s) "
              f"next to it ({', '.join(os.path.basename(s) for s in shards)}) "
              f"— {cmd}ing only the base store would operate on a stale "
              f"partial copy. Run `python -m repro_torch.tuna sync --db {args.db} "
              f"--num-shards N` first, pass --transport to pull the fleet's "
              f"shards here, or pass --ignore-shards to {cmd} just the "
              f"base store anyway", file=sys.stderr)
        return 2
    return 0


def cmd_compact(args: argparse.Namespace) -> int:
    rc = _pull_fleet_or_fail(args, "compact")
    if rc:
        return rc
    db = ScheduleDatabase(args.db)
    dropped = db.compact()
    print(f"[tuna] compacted {args.db}: {len(db)} keys kept, "
          f"{dropped} superseded lines dropped")
    if args.transport:
        from repro_torch.tuna.transport import resolve_transport

        # push the compacted store back under its base name: the channel's
        # authoritative merged object for downstream pulls (sync only ever
        # pulls shard-named objects, so this can't shadow a shard store)
        t = resolve_transport(args.transport)
        man = t.push(args.db, os.path.basename(args.db))
        print(f"[tuna] pushed {man.name} ({man.records} records, "
              f"sha1 {man.sha1[:12]}) -> {t.describe()}")
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    rc = _pull_fleet_or_fail(args, "export")
    if rc:
        return rc
    db = ScheduleDatabase(args.db)
    n = db.export(args.out)
    print(f"[tuna] exported {n} records -> {args.out}")
    return 0


def cmd_golden(args: argparse.Namespace) -> int:
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    from repro_torch.tuna.golden import (
        GoldenError,
        GoldenManager,
        GoldenRegressionError,
        build_kernel_bundle,
    )

    records = ScheduleDatabase(args.db).records()
    if not any(r.version == COST_MODEL_VERSION for r in records):
        print(f"error: {args.db}: no records under cost-model version "
              f"{COST_MODEL_VERSION!r} — tune first", file=sys.stderr)
        return 2
    mgr = GoldenManager(args.dir)
    try:
        info = mgr.promote(records, args.target, waive=args.waive or (),
                           force=args.force, source=args.db)
    except GoldenRegressionError as e:
        print(f"[tuna] REFUSED golden promotion for {args.target}: {e}",
              file=sys.stderr)
        return 1
    except GoldenError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    state = "promoted" if info.rebuilt else "up to date"
    gate = (f"gated against {info.predecessor}, "
            f"{info.gated_against} schedules checked"
            if info.predecessor else "first release in this lineage")
    print(f"[tuna] golden {info.name}: {info.count} schedules "
          f"({state}; {gate}; latest -> {info.name})")
    for w in info.waived:
        print(f"[tuna]   WAIVED (--waive {w.waived_by!r}): {w.describe()}",
              file=sys.stderr)
    bundle = None
    if args.bundle:
        _, release = mgr.load_release(info.path)
        bundle = build_kernel_bundle(release, args.dir, args.target,
                                     golden_name=info.name,
                                     device=args.device)
        print(f"[tuna] bundle {bundle.name}: {bundle.entries} bundled "
              f"kernel(s) over {bundle.schedules} schedules, "
              f"{bundle.bytes} B")
        for name, lib in sorted(bundle.libraries.items()):
            print(f"[tuna]   library {name}: {lib['file']}, "
                  f"{lib['bytes']} B, sha1 {lib['sha1']}")
        for op, why in bundle.skipped:
            print(f"[tuna]   no bundled kernel for {op}: {why}")
    if args.publish:
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(args.publish)
        for man in mgr.publish(t, info, bundle=bundle):
            print(f"[tuna] published {man.name} ({man.size}B, "
                  f"sha1 {man.sha1[:12]}) -> {t.describe()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.tuna", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tune", help="run tuning jobs into the DB")
    _add_db(p)
    p.add_argument("--ops", default="all",
                   help="comma-separated configs.tuna_ops names, or 'all'")
    p.add_argument("--targets", default=DEFAULT_TARGETS)
    p.add_argument("--strategy", choices=["exhaustive", "es"],
                   default="exhaustive")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--limit", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny fixed job set (CI cold-start check)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="fleet size: stable-hash the job matrix into this "
                        "many disjoint shards")
    p.add_argument("--shard-id", type=int, default=0,
                   help="which shard this host owns (writes to "
                        "<db>.shardNN.jsonl)")
    p.add_argument("--transport", default=None, metavar="SPEC",
                   help="push the finished store into this channel "
                        "(dir:///path, mem://bucket, or a bare directory) "
                        "so the sync host needs no shared filesystem")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("sync", help="merge per-shard stores into the base DB")
    _add_db(p, help="base store path")
    p.add_argument("--num-shards", type=int, required=True)
    p.add_argument("--no-provenance", action="store_true",
                   help="do not stamp meta.provenance on absorbed records")
    p.add_argument("--no-compact", action="store_true",
                   help="keep the merged log uncompacted")
    p.add_argument("--transport", default=None, metavar="SPEC",
                   help="pull shard stores from this channel (integrity-"
                        "verified) instead of the shared filesystem")
    p.add_argument("--staging-dir", default=None,
                   help="where transport pulls land (default "
                        "<db>.staging/)")
    p.add_argument("--verify", default=None, metavar="REF_DB",
                   help="fail (exit 1) if the merged store diverges from "
                        "this reference store, or if any corrupt source "
                        "line was dropped")
    p.set_defaults(fn=cmd_sync)

    p = sub.add_parser("snapshot",
                       help="compile the store into a serving cache")
    _add_db(p)
    p.add_argument("--out", default=None,
                   help="the snapshot file (needed without --dir)")
    p.add_argument("--dir", default=None, metavar="OUT_DIR",
                   help="snapshot lifecycle mode: keep versioned snapshots "
                        "(<prefix>.<cm-version>-<digest>.json) plus a "
                        "`latest` pointer in this directory; rebuilds only "
                        "when the store or cost-model version changed")
    p.add_argument("--force", action="store_true",
                   help="with --dir: rewrite the snapshot even if current")
    p.add_argument("--publish", default=None, metavar="SPEC",
                   help="push the snapshot (and, with --dir, the latest "
                        "pointer) over this transport")
    p.set_defaults(fn=cmd_snapshot)

    p = sub.add_parser("query", help="print best records")
    _add_db(p, help="the JSONL DB (needed without --snapshot)", required=False)
    p.add_argument("--snapshot", default=None,
                   help="query a compiled snapshot (or a `latest` pointer) "
                        "instead of the JSONL DB")
    p.add_argument("--allow-stale", action="store_true",
                   help="load a snapshot built under a different cost-model "
                        "version anyway (flagged on stderr) instead of "
                        "failing")
    p.add_argument("--op", default=None, help="exact op signature or prefix")
    p.add_argument("--target", default=None)
    p.add_argument("--version", default=None)
    p.add_argument("--json", action="store_true",
                   help="emit one JSON array (the serialization export "
                        "uses) instead of JSONL lines")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("compact", help="drop superseded log lines")
    _add_db(p)
    p.add_argument("--transport", default=None, metavar="SPEC",
                   help="pull the fleet's published shard stores (needs "
                        "--num-shards) and merge them before compacting, "
                        "then push the compacted store back under its "
                        "base name")
    p.add_argument("--num-shards", type=int, default=0,
                   help="fleet size for --transport pulls")
    p.add_argument("--staging-dir", default=None,
                   help="where transport pulls land (default <db>.staging/)")
    p.add_argument("--ignore-shards", action="store_true",
                   help="compact just the base store even when per-shard "
                        "stores sit next to it (default: fail fast — the "
                        "base alone is a stale partial copy)")
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser("export", help="dump best records as JSON")
    _add_db(p)
    p.add_argument("--out", required=True)
    p.add_argument("--transport", default=None, metavar="SPEC",
                   help="pull the fleet's published shard stores (needs "
                        "--num-shards) and merge them before exporting")
    p.add_argument("--num-shards", type=int, default=0,
                   help="fleet size for --transport pulls")
    p.add_argument("--staging-dir", default=None,
                   help="where transport pulls land (default <db>.staging/)")
    p.add_argument("--ignore-shards", action="store_true",
                   help="export just the base store even when per-shard "
                        "stores sit next to it (default: fail fast)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "golden",
        help="freeze the store into a regression-gated golden release "
             "(+ optional kernel bundle)")
    _add_db(p)
    p.add_argument("--target", default=TARGET_NAMES[0],
                   help="the target whose records are promoted")
    p.add_argument("--dir", default=os.path.join("build", "golden"),
                   metavar="OUT_DIR",
                   help="golden release directory (default build/golden "
                        "under the working directory, which .gitignore "
                        "lists): versioned releases "
                        "(golden.<target>.<cm-version>-<digest>.json), "
                        "bundles, and their `latest` pointers")
    p.add_argument("--waive", action="append", default=None,
                   metavar="OP[@TARGET]",
                   help="accept a specific regression vs the previous "
                        "golden; repeatable, recorded in the release "
                        "manifest")
    p.add_argument("--force", action="store_true",
                   help="rewrite the release file even if its "
                        "content-addressed name already exists")
    p.add_argument("--bundle", action="store_true",
                   help="bundle the release's kernels with the compiled "
                        "sm_90a libraries (bundle.<target>.<cm-version>-"
                        "<digest>.json): what `launch/serve.py "
                        "--kernel-bundle` loads")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the bundle carries the libraries "
                        "(needs nvcc, not a card); cpu: entries run the "
                        "plain versions, for a process on the CPU")
    p.add_argument("--publish", default=None, metavar="SPEC",
                   help="push the release (+ bundle) and their `latest` "
                        "pointers over this transport")
    p.set_defaults(fn=cmd_golden)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # downstream head/pager closed the pipe: the unix-normal exit.
        # Re-point stdout at devnull so interpreter shutdown doesn't print
        # a spurious "Exception ignored" on the final flush.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
