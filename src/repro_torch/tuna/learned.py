"""Offline training of the learned ranker from the JSONL schedule store.

The port's own copy of ``repro.tuna.learned``, held against it by
``tests/test_torch_learned.py``.

The store's append-only *log* (not the best-record index — that keeps only
winners) is the training set: every line is one (op signature, target,
config, score) sample, which is exactly what TLP and the TPU learned
performance model train on. ``train_from_store`` reads the full log,
reconstructs each record's schedule space from its op signature
(``core.learned.space_from_signature``), featurizes statically, and fits
the ridge ranker with per-lineage target standardisation — datasheet
``cm1`` scores, host-calibrated ``cm1-cal-<fp>`` scores, and measured
``cm1-meas`` seconds never mix scales.

``LearnedManager`` is the artifact lifecycle, mirroring
``SnapshotManager``'s ensure-on-change contract: artifacts get
content-addressed names (``learned.<version>-<digest12>.json``) plus an
atomic ``latest`` pointer that records the sha1 of the *training rows* the
model was fitted from — ``ensure()`` retrains exactly when the store's
training content or the cost-model version changed and is a cheap no-op
otherwise (safe to run every controller reconcile), and ``publish`` ships
payload-before-pointer over any ``repro_torch.tuna.transport`` channel.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.core.learned import (
    LEARNED_POINTER_SCHEMA,
    LearnedRanker,
    featurize,
    fit_ranker,
    load_ranker,
    save_ranker,
    space_from_signature,
)
from repro_torch.hw import get_target
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord


def iter_log_records(db_path: str) -> List[ScheduleRecord]:
    """Every parseable record in the store's log — full history, not just
    the per-key winners the index keeps. Superseded records are the
    valuable part of a training set: they say which configs *lost*."""
    db = ScheduleDatabase(None)
    return list(db._iter_file(os.fspath(db_path), lock=True))


def is_training_row(rec: ScheduleRecord) -> bool:
    """A record the ranker may train on: scored under this cost-model
    family (``cm1...`` lineages, measured ``cm1-meas`` included), and NOT
    written by a learned ranker itself (``+lr`` in the version) — a model
    must never train on its own hybrid write-backs."""
    return (rec.version.startswith(COST_MODEL_VERSION)
            and "+lr" not in rec.version)


def training_rows(records: Sequence[ScheduleRecord]) -> List[ScheduleRecord]:
    return [r for r in records if is_training_row(r)]


def training_sha1(rows: Sequence[ScheduleRecord]) -> str:
    """Content digest of the training set (order-independent, bookkeeping
    meta excluded) — what the ``latest`` pointer records and ``ensure``
    compares, so a fleet sync that only reorders or restamps lines does
    not trigger a retrain."""
    canon = sorted(
        json.dumps([r.op, r.target, r.version, r.config, float(r.score)],
                   sort_keys=True, default=float)
        for r in rows
    )
    return hashlib.sha1("\n".join(canon).encode()).hexdigest()


def build_dataset(
    rows: Sequence[ScheduleRecord], augment: int = 0, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, List[str], int]:
    """Featurize training rows → ``(X, y, group_ids, skipped)``.

    Group ids are ``<version>@<op>@<target>`` — standardisation groups.
    Within a group every score came from the same lineage *and* the same
    schedule space, so relative order is exactly the ranking signal we
    want; across groups nothing is compared. Rows whose space cannot be
    reconstructed (foreign op families) or whose config no longer
    instantiates are skipped, not fatal.

    ``augment > 0`` adds up to that many statically-scored (free, no
    hardware) configs per distinct (op, target) — ``cm1`` lineage — so
    spaces with only a handful of stored winners still teach the model the
    shape of their cost surface.
    """
    X: List[np.ndarray] = []
    y: List[float] = []
    groups: List[str] = []
    skipped = 0
    spaces: Dict[Tuple[str, str], object] = {}

    def space_for(op: str, target_name: str):
        key = (op, target_name)
        if key not in spaces:
            try:
                target = get_target(target_name)
            except (KeyError, ValueError):
                spaces[key] = (None, None)
            else:
                spaces[key] = (space_from_signature(op, target), target)
        return spaces[key]

    for rec in rows:
        space, target = space_for(rec.op, rec.target)
        if space is None or rec.score <= 0:
            skipped += 1
            continue
        try:
            X.append(featurize(space, target, dict(rec.config),
                               hlo_text=rec.meta.get("hlo")))
        except (KeyError, ValueError, TypeError):
            skipped += 1
            continue
        y.append(float(rec.score))
        groups.append(f"{rec.version}@{rec.op}@{rec.target}")

    if augment > 0:
        from repro_torch.core import cost_model

        rng = np.random.default_rng(seed)
        seen = {(r.op, r.target) for r in rows}
        for op, target_name in sorted(seen):
            space, target = space_for(op, target_name)
            if space is None:
                continue
            cfgs = list(space.enumerate(space.size()))
            if len(cfgs) > augment:
                idx = rng.choice(len(cfgs), size=augment, replace=False)
                cfgs = [cfgs[i] for i in sorted(idx)]
            for cfg in cfgs:
                try:
                    prog, meta = space.instantiate(cfg)
                    s = cost_model.evaluate(prog, target, meta)
                    X.append(featurize(space, target, cfg))
                except (KeyError, ValueError, TypeError):
                    continue
                y.append(float(s))
                groups.append(f"{COST_MODEL_VERSION}@{op}@{target_name}")

    if not X:
        return (np.zeros((0, 0)), np.zeros(0), [], skipped)
    return (np.stack(X), np.asarray(y, dtype=np.float64), groups, skipped)


def train_from_store(
    db_path: str, augment: int = 0, seed: int = 0, l2: float = 1e-2,
) -> Tuple[LearnedRanker, str, int, int]:
    """Fit a ranker from a store's log. Returns ``(model, train_sha1,
    n_samples, n_skipped)``. Raises ``ValueError`` when the store yields
    no usable training rows."""
    rows = training_rows(iter_log_records(db_path))
    tsha = training_sha1(rows)
    X, y, groups, skipped = build_dataset(rows, augment=augment, seed=seed)
    if len(y) < 2:
        raise ValueError(
            f"{db_path}: only {len(y)} usable training sample(s) "
            f"({skipped} skipped) — tune more operators into the store "
            f"first (`python -m repro_torch.tuna tune`), or collect measured "
            f"samples (`python -m repro_torch.benchmarks.topk_ratio "
            f"--collect`)")
    model = fit_ranker(X, y, groups, l2=l2)
    # the artifact records lineage composition at version granularity —
    # the (op, target) refinement used for standardisation stays internal
    by_version: Dict[str, int] = {}
    for g in groups:
        v = g.split("@", 1)[0]
        by_version[v] = by_version.get(v, 0) + 1
    model.lineages = by_version
    return model, tsha, len(y), skipped


# -- artifact lifecycle ------------------------------------------------------

@dataclasses.dataclass
class LearnedInfo:
    """What ``LearnedManager.ensure`` did: the versioned artifact path, the
    ``latest`` pointer path, and whether a retrain happened."""

    name: str
    path: str
    latest: str
    sha1: str
    version: str
    train_sha1: str
    samples: int
    skipped: int
    retrained: bool   # a new versioned artifact was fitted + written
    repointed: bool   # the latest pointer moved
    built_at: Optional[float] = None


class LearnedManager:
    """Keeps a directory of versioned learned-ranker artifacts consistent
    with a store — ``SnapshotManager``'s ensure-on-change contract applied
    to model training. Identity is the pair (training-row sha1, cost-model
    version): a fleet sync that adds records retrains, a restamp/reorder
    does not, and a ``COST_MODEL_VERSION`` bump always does."""

    def __init__(self, db_path: str, out_dir: str, prefix: str = "learned",
                 augment: int = 0, seed: int = 0, l2: float = 1e-2):
        self.db_path = os.fspath(db_path)
        self.out_dir = os.fspath(out_dir)
        self.prefix = prefix
        self.augment = augment
        self.seed = seed
        self.l2 = l2

    @property
    def latest_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.prefix}.latest.json")

    def artifact_name(self, version: str, sha1: str) -> str:
        return f"{self.prefix}.{version}-{sha1[:12]}.json"

    def current(self) -> Optional[Dict]:
        """The latest pointer object, or None when never trained."""
        try:
            with open(self.latest_path, "r", encoding="utf-8") as f:
                obj = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(obj, dict) or \
                obj.get("schema") != LEARNED_POINTER_SCHEMA:
            return None
        return obj

    def load(self) -> LearnedRanker:
        """Load the currently-pointed artifact (verified — see
        ``core.learned.load_ranker``)."""
        return load_ranker(self.latest_path)

    def ensure(self, force: bool = False) -> LearnedInfo:
        """Retrain iff the store's training content or the cost-model
        version changed since the pointed artifact was fitted (or
        ``force``); repoint ``latest`` at the result. Old versioned
        artifacts stay in place for in-flight pulls."""
        rows = training_rows(iter_log_records(self.db_path))
        tsha = training_sha1(rows)
        cur = self.current()
        fresh = (
            not force
            and cur is not None
            and cur.get("train_sha1") == tsha
            and cur.get("cost_model_version") == COST_MODEL_VERSION
            and cur.get("augment") == self.augment
            and cur.get("seed") == self.seed
            and cur.get("l2") == self.l2
            and os.path.exists(os.path.join(self.out_dir, cur["artifact"]))
        )
        if fresh:
            return LearnedInfo(
                name=cur["artifact"],
                path=os.path.join(self.out_dir, cur["artifact"]),
                latest=self.latest_path, sha1=cur.get("sha1", ""),
                version=cur.get("version", ""), train_sha1=tsha,
                samples=int(cur.get("samples", 0)),
                skipped=int(cur.get("skipped", 0)),
                retrained=False, repointed=False,
                built_at=cur.get("built_at"))
        model, tsha, samples, skipped = train_from_store(
            self.db_path, augment=self.augment, seed=self.seed, l2=self.l2)
        name = self.artifact_name(model.version, model.fingerprint())
        path = os.path.join(self.out_dir, name)
        sha1 = save_ranker(model, path)
        repointed = cur is None or cur.get("artifact") != name or \
            cur.get("train_sha1") != tsha
        self._write_pointer(name, sha1, model, tsha, samples, skipped)
        return LearnedInfo(name=name, path=path, latest=self.latest_path,
                           sha1=sha1, version=model.version,
                           train_sha1=tsha, samples=samples, skipped=skipped,
                           retrained=True, repointed=repointed,
                           built_at=model.built_at)

    def _write_pointer(self, name: str, sha1: str, model: LearnedRanker,
                       train_sha1: str, samples: int, skipped: int) -> None:
        obj = {
            "schema": LEARNED_POINTER_SCHEMA,
            "artifact": name,
            "sha1": sha1,
            "fingerprint": model.fingerprint(),
            "version": model.version,
            "cost_model_version": model.cost_model_version,
            "train_sha1": train_sha1,
            "samples": samples,
            "skipped": skipped,
            "lineages": model.lineages,
            "augment": self.augment,
            "seed": self.seed,
            "l2": self.l2,
            "built_at": model.built_at,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".pointer.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(obj, f, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.latest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def publish(self, transport, info: Optional[LearnedInfo] = None) -> List:
        """``ensure`` + push the versioned artifact then the ``latest``
        pointer over a transport (payload-before-pointer: a puller that
        sees the new pointer can always pull the artifact it names).
        Returns the manifests."""
        from repro_torch.tuna.transport import resolve_transport

        t = resolve_transport(transport)
        if info is None:
            info = self.ensure()
        manifests = [t.push(info.path, info.name)]
        manifests.append(t.push(self.latest_path,
                                os.path.basename(self.latest_path)))
        return manifests
