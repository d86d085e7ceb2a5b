"""Parallel tuning orchestrator — fan (operator space × target) jobs out
across a process pool and stream results into the schedule database.

The port's own copy of ``repro.tuna.orchestrator``, over the port's
targets (``gpu_h100``) and its operator registry.

Static analysis is embarrassingly parallel: scoring needs no device, only
host cores (the paper's §V compilation-time edge), so any machine can be a
tuning worker — the MITuna builder/evaluator split collapses to a process
pool here. Failures retry with capped attempts; every completed job appends
one ``cm1`` record to the store as it lands (no end-of-run barrier).

The worker path scores with numpy-backed modules and reads no device;
``start_method="spawn"`` is the default to stay safe under hosts where the
parent has already initialised threaded runtimes (a CUDA context among
them).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing
import time
import traceback
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.tuna_ops import OPERATORS
from repro_torch.core import tuner
from repro_torch.hw import get_target
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord, stamp_tuned_at


@dataclasses.dataclass(frozen=True)
class TuneJob:
    """One unit of work: tune operator ``op`` (a ``configs.tuna_ops`` name)
    for ``target`` with the given search strategy."""

    op: str
    target: str = "gpu_h100"
    strategy: str = "exhaustive"  # "exhaustive" | "es"
    limit: int = 1024             # exhaustive enumeration cap
    iterations: int = 12          # es knobs
    population: int = 16
    seed: int = 0


@dataclasses.dataclass
class JobFailure:
    job: TuneJob
    error: str
    attempts: int


@dataclasses.dataclass
class RunReport:
    records: List[ScheduleRecord]
    failures: List[JobFailure]
    wall_seconds: float

    @property
    def ok(self) -> bool:
        return not self.failures


def build_space(job: TuneJob):
    try:
        factory = OPERATORS[job.op]
    except KeyError:
        raise KeyError(
            f"unknown operator {job.op!r}; have {sorted(OPERATORS)}")
    return factory(get_target(job.target).kind)


def run_job(job: TuneJob) -> ScheduleRecord:
    """Execute one job to a finished ``cm1`` record (module-level so it
    pickles under spawn)."""
    space = build_space(job)
    target = get_target(job.target)
    default_score = tuner._score_config(space, target,
                                        space.default_config())
    if job.strategy == "exhaustive":
        ranked = tuner.rank_space(space, target, limit=job.limit, db=False)
        cfg, score = ranked[0]
        evaluations = len(ranked)
    elif job.strategy == "es":
        res = tuner.tune(space, target, iterations=job.iterations,
                         population=job.population, seed=job.seed,
                         workers=1, db=False)
        cfg, score, evaluations = res.config, res.score, res.evaluations
    else:
        raise ValueError(f"unknown strategy {job.strategy!r}")
    return ScheduleRecord(
        op=space.signature(),
        target=target.name,
        config=dict(cfg),
        score=score,
        evaluations=evaluations,
        meta=stamp_tuned_at(
            {"strategy": job.strategy, "default_score": default_score}),
    )


def run(
    jobs: Sequence[TuneJob],
    db: Optional[ScheduleDatabase] = None,
    workers: int = 4,
    retries: int = 2,
    start_method: str = "spawn",
    verbose: bool = False,
    runner=run_job,
) -> RunReport:
    """Fan ``jobs`` out over ``workers`` processes (inline when ``workers <=
    1``), retrying each failed job up to ``retries`` extra times, streaming
    completed records into ``db``. ``runner`` must be a picklable
    module-level callable (the fleet and tests substitute it).

    Retry accounting is per *submission*, not per job value: ``TuneJob`` is
    a frozen dataclass, so duplicate jobs in one run compare equal — keying
    attempts by the job itself would make duplicates share one counter and
    exhaust each other's retries."""
    t0 = time.perf_counter()
    records: List[ScheduleRecord] = []
    failures: List[JobFailure] = []

    def _land(rec: ScheduleRecord) -> None:
        if db is not None:
            db.add(rec)
        records.append(rec)
        if verbose:
            print(f"[tuna] {rec.op} @ {rec.target}: score={rec.score:.3e} "
                  f"evals={rec.evaluations} ({rec.meta.get('strategy')})")

    if workers <= 1:
        for job in jobs:
            err, attempts = "", 0
            for attempt in range(retries + 1):
                attempts = attempt + 1
                try:
                    _land(runner(job))
                    break
                except Exception:  # noqa: BLE001
                    err = traceback.format_exc(limit=3)
            else:
                failures.append(JobFailure(job, err, attempts))
        return RunReport(records, failures, time.perf_counter() - t0)

    ctx = multiprocessing.get_context(start_method)
    attempts: Dict[int, int] = {}  # submission index -> attempts so far
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        pending = {}
        for idx, job in enumerate(jobs):
            pending[pool.submit(runner, job)] = (idx, job)
            attempts[idx] = 1
        while pending:
            done, _ = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for fut in done:
                idx, job = pending.pop(fut)
                try:
                    _land(fut.result())
                except Exception:  # noqa: BLE001
                    if attempts[idx] <= retries:
                        attempts[idx] += 1
                        pending[pool.submit(runner, job)] = (idx, job)
                    else:
                        failures.append(JobFailure(
                            job, traceback.format_exc(limit=3),
                            attempts[idx]))
    return RunReport(records, failures, time.perf_counter() - t0)


def jobs_for(ops: Sequence[str], targets: Sequence[str],
             strategy: str = "exhaustive", limit: int = 1024,
             seed: int = 0) -> List[TuneJob]:
    return [TuneJob(op=op, target=t, strategy=strategy, limit=limit,
                    seed=seed)
            for op in ops for t in targets]
