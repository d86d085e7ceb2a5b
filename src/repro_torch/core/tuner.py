"""Tuna tuner — the public entry point tying Eq. (1) together:

    argmin_{t ∈ T_e}  c(f(g(e, t), a))

The port's own copy of ``repro.core.tuner``, held against it by
``tests/test_torch_core.py`` and ``tests/test_torch_tuna.py``.
``tune(space, target)`` runs the ES search (Alg. 4) with the static cost
model as fitness; ``rank_space`` exhaustively scores a space (used by the
top-k benchmark and by the matmul block picker, whose spaces are small).
``tuned_matmul_blocks`` memoises the Hopper matmul pick per shape, so
``kernels/ops.matmul`` pays the pick once.

Persistence: because scores are pure functions of (op signature, target,
cost-model version), the entry points consult the schedule store before
searching and write back on a miss. ``db`` arguments accept a
``ScheduleDatabase``, a path, ``None`` (= the process default set via
``set_default_db`` / the ``REPRO_TUNA_DB`` env var), or ``False`` (bypass —
used by the orchestrator, which manages its own store). An immutable
serving snapshot (``repro_torch.tuna.cache.ScheduleCache``, installed via
``set_default_cache`` / ``$REPRO_TUNA_CACHE``) is consulted before the DB
on every read — the lock-free hot path for serving processes. A golden
kernel bundle (``repro_torch.tuna.golden.KernelBundle``, installed via
``set_default_bundle`` / ``$REPRO_TUNA_BUNDLE``) is consulted before both:
the blessed-release tier (bundle → snapshot → DB → cost model). The files
and env variables are the reference's; records are keyed by target, so a
store shared with the reference is harmless.

Not ported yet: the reference's learned re-ranker
(``set_default_learned``) and calibrated coefficients (ROADMAP Queue A 9);
with no calibration every record the port writes is the datasheet ``cm1``
version, so the reference's ``record_version`` (the calibrated-coefficient
fingerprint) comes with calibration.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import cost_model, es
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.core.spaces import MatmulSpace, Space
from repro_torch.hw.gpu_h100 import GPU_H100
from repro_torch.hw.target import HardwareTarget

_UNSET = object()
_DEFAULT_DB = _UNSET  # _UNSET = fall back to $REPRO_TUNA_DB; None = off
_DEFAULT_CACHE = _UNSET  # _UNSET = fall back to $REPRO_TUNA_CACHE
_DEFAULT_BUNDLE = _UNSET  # _UNSET = fall back to $REPRO_TUNA_BUNDLE
# the device a bundle named by $REPRO_TUNA_BUNDLE is loaded for (the card,
# as every entry point defaults to it)
BUNDLE_DEVICE = "cuda"
_DEFAULT_CACHE_PATH: Optional[str] = None  # where the default snapshot was
#                                   installed from — what hot reload rechecks
_PATH_DBS: Dict[str, object] = {}  # abspath -> ScheduleDatabase (one load
#                                    per path per process, not per call)
_PATH_CACHES: Dict[str, object] = {}  # abspath -> (sha1, ScheduleCache)
_MEMO_CLEARERS: List = []  # block-pick lru cache_clear hooks (kernels/ops
#                            registers tuned_flash_blocks here — the tuner
#                            does not import the kernels)


def register_memo_clearer(fn) -> None:
    _MEMO_CLEARERS.append(fn)


def _clear_memos() -> None:
    tuned_matmul_blocks.cache_clear()
    for fn in _MEMO_CLEARERS:
        fn()


def _open_db(path):
    key = os.path.abspath(os.fspath(path))
    if key not in _PATH_DBS:
        from repro_torch.tuna.db import ScheduleDatabase

        _PATH_DBS[key] = ScheduleDatabase(key)
    return _PATH_DBS[key]


def set_default_db(db) -> None:
    """Install the process-wide warm schedule DB (path or ScheduleDatabase).
    ``None`` switches the default OFF, including the ``$REPRO_TUNA_DB``
    fallback. Clears the block-pick memos so shapes already picked
    re-resolve against the new store."""
    global _DEFAULT_DB
    if isinstance(db, (str, os.PathLike)):
        db = _open_db(db)
    _DEFAULT_DB = db
    _clear_memos()


def get_default_db():
    """The installed default DB, else one opened from ``$REPRO_TUNA_DB``."""
    global _DEFAULT_DB
    if _DEFAULT_DB is _UNSET:
        path = os.environ.get("REPRO_TUNA_DB")
        _DEFAULT_DB = _open_db(path) if path else None
    return _DEFAULT_DB


def resolve_db(db):
    """Coerce a ``db`` argument to a ScheduleDatabase or None: ``False`` →
    off, ``None`` → the process default, a path → the per-path cached
    instance (one log read per process), an instance → itself (a
    ``ScheduleCache`` instance acts as a read-only store)."""
    if db is False:
        return None
    if db is None:
        return get_default_db()
    if isinstance(db, (str, os.PathLike)):
        return _open_db(db)
    return db


def _writable(store) -> bool:
    """Write-back gate: ``ScheduleCache`` is an immutable snapshot, so
    results found by a live search are not persisted through it."""
    return store is not None and not getattr(store, "immutable", False)


def _open_cache(path):
    """Per-path snapshot instances, revalidated by the snapshot's stored
    content digest (a cheap header read — no record parsing): a snapshot
    is immutable once loaded, so a republished file must hand out a fresh
    instance. A stat stamp (mtime and size) would miss a pull that keeps
    the timestamp with an equal-size payload. ``latest`` pointer files
    revalidate the same way: the pointer header carries the target's
    sha1, so repointing changes the stamp."""
    key = os.path.abspath(os.fspath(path))
    from repro_torch.tuna.cache import ScheduleCache, read_snapshot_header

    stamp = read_snapshot_header(key).get("sha1")
    cached = _PATH_CACHES.get(key)
    if cached is None or stamp is None or cached[0] != stamp:
        _PATH_CACHES[key] = (stamp, ScheduleCache.load(key))
    return _PATH_CACHES[key][1]


def set_default_cache(cache) -> None:
    """Install the process-wide serving snapshot (path or ScheduleCache),
    consulted *before* the schedule DB on every read. ``None`` switches it
    OFF, including the ``$REPRO_TUNA_CACHE`` fallback. Clears the
    block-pick memos. Installing a path remembers it, so
    ``refresh_default_cache`` can hot-swap when the snapshot is
    republished. A missing, corrupt, or stale (wrong
    ``COST_MODEL_VERSION``) snapshot raises — an explicit install must
    never silently serve nothing."""
    global _DEFAULT_CACHE, _DEFAULT_CACHE_PATH
    if isinstance(cache, (str, os.PathLike)):
        path = os.path.abspath(os.fspath(cache))
        cache = _open_cache(path)
        _DEFAULT_CACHE_PATH = path
    else:
        _DEFAULT_CACHE_PATH = None
    _DEFAULT_CACHE = cache
    _clear_memos()


def get_default_cache():
    """The installed snapshot, else one loaded from ``$REPRO_TUNA_CACHE``.
    An env-var path that does not exist yet (snapshot not built) resolves
    to OFF instead of failing every lookup; so does a *stale* one, with a
    ``StaleSnapshotWarning``. Either way the path is remembered so
    ``refresh_default_cache`` picks up the rebuilt snapshot without a
    restart."""
    global _DEFAULT_CACHE, _DEFAULT_CACHE_PATH
    if _DEFAULT_CACHE is _UNSET:
        path = os.environ.get("REPRO_TUNA_CACHE")
        if not path:
            _DEFAULT_CACHE = None
        else:
            from repro_torch.tuna.cache import (StaleSnapshotError,
                                                StaleSnapshotWarning)

            _DEFAULT_CACHE_PATH = os.path.abspath(path)
            try:
                _DEFAULT_CACHE = _open_cache(path)
            except FileNotFoundError:
                _DEFAULT_CACHE = None  # not built yet; refresh may find it
                _clear_memos()
            except StaleSnapshotError as e:
                import warnings

                warnings.warn(f"$REPRO_TUNA_CACHE disabled: {e}",
                              StaleSnapshotWarning, stacklevel=2)
                _DEFAULT_CACHE = None
                # picks memoised under an earlier snapshot must not outlive
                # its rejection
                _clear_memos()
    return _DEFAULT_CACHE


def refresh_default_cache() -> bool:
    """Hot-reload the default serving snapshot if its content changed.

    Long-running serve processes call this between waves or at admission:
    it re-reads the snapshot header at the installed path (following a
    ``latest`` pointer), compares the stored sha1 against the instance
    being served, and swaps in a fresh ``ScheduleCache`` — clearing the
    block-pick memos — when a republish landed. Returns True iff a swap
    happened (the new instance starts with zeroed hit/miss counters).
    While the new file is missing, torn, mid-publish, or stale, the
    current instance keeps serving."""
    global _DEFAULT_CACHE
    cur = get_default_cache()  # resolves the env var on first use
    path = _DEFAULT_CACHE_PATH
    if path is None:
        return False
    try:
        new = _open_cache(path)
    except (OSError, ValueError):
        # missing/unreadable file or a stale/corrupt snapshot
        # (StaleSnapshotError is a ValueError): keep serving
        return False
    if new is cur:
        return False
    _DEFAULT_CACHE = new
    _clear_memos()
    return True


def _swap_bundle(bundle) -> None:
    """Make ``bundle`` the default: its libraries installed in
    ``kernels.build`` before anything launches (a CPU bundle has none),
    the previous bundle's removed, the block-pick memos cleared."""
    global _DEFAULT_BUNDLE
    old = None if _DEFAULT_BUNDLE is _UNSET else _DEFAULT_BUNDLE
    if bundle is not None and bundle is not old:
        bundle.install()
    if old is not None and old is not bundle:
        old.uninstall()
    _DEFAULT_BUNDLE = bundle
    _clear_memos()


def set_default_bundle(bundle, device: str = "cuda") -> None:
    """Install the process-wide golden kernel bundle
    (``repro_torch.tuna.golden.KernelBundle``, or a path/`latest` pointer
    to one, loaded for ``device``), consulted before the snapshot cache
    *and* the DB on every read — the blessed-release tier — and by
    ``kernels.ops`` before it picks blocks. A CUDA bundle's verified
    libraries are installed at once, so no launch builds. ``None``
    switches it OFF, including the ``$REPRO_TUNA_BUNDLE`` fallback, and
    removes its libraries. Clears the block-pick memos. A missing, torn,
    stale or foreign bundle raises."""
    if isinstance(bundle, (str, os.PathLike)):
        from repro_torch.tuna.golden import KernelBundle

        bundle = KernelBundle.load(bundle, device=device)
    _swap_bundle(bundle)


def get_default_bundle():
    """The installed kernel bundle, else one loaded from
    ``$REPRO_TUNA_BUNDLE`` for ``BUNDLE_DEVICE``. Mirrors
    ``get_default_cache``'s env handling: a path that does not exist
    resolves to OFF; a stale bundle (different ``COST_MODEL_VERSION``)
    resolves to OFF with a ``StaleSnapshotWarning``; both degrade paths
    clear the block-pick memos. Any other refusal raises."""
    if _DEFAULT_BUNDLE is _UNSET:
        path = os.environ.get("REPRO_TUNA_BUNDLE")
        bundle = None
        if path:
            from repro_torch.tuna.cache import (StaleSnapshotError,
                                                StaleSnapshotWarning)
            from repro_torch.tuna.golden import KernelBundle

            try:
                bundle = KernelBundle.load(path, device=BUNDLE_DEVICE)
            except FileNotFoundError:
                pass
            except StaleSnapshotError as e:
                import warnings

                warnings.warn(f"$REPRO_TUNA_BUNDLE disabled: {e}",
                              StaleSnapshotWarning, stacklevel=2)
        _swap_bundle(bundle)
    return _DEFAULT_BUNDLE


def _lookup(op: str, target_name: str, version: str, db):
    """Read path shared by tune/best_schedule/the block pickers: the
    golden kernel bundle, the snapshot cache (O(1), lock-free), then the
    schedule DB. Returns ``(record or None, "bundle"|"cache"|"db"|"")`` and
    never searches."""
    bundle = get_default_bundle()
    if bundle is not None:
        rec = bundle.best(op, target_name, version)
        if rec is not None:
            return rec, "bundle"
    cache = get_default_cache()
    if cache is not None:
        rec = cache.best(op, target_name, version)
        if rec is not None:
            return rec, "cache"
    store = resolve_db(db)
    if store is not None and store is not cache:
        rec = store.best(op, target_name, version)
        if rec is not None:
            return rec, "db"
    return None, ""


def lookup_best(op: str, target_name: str,
                version: str = COST_MODEL_VERSION, db=None):
    """Best stored record for a key — the kernel bundle, the serving cache,
    then the DB (``db`` follows ``resolve_db`` semantics). None on a full
    miss."""
    return _lookup(op, target_name, version, db)[0]


@dataclasses.dataclass
class TuneResult:
    config: Dict
    score: float
    evaluations: int
    wall_seconds: float
    history: List[float]
    default_score: float  # score of the space's centre config (no tuning)
    from_db: bool = False  # True when served from the schedule store
    from_cache: bool = False  # True when the hit came from a ScheduleCache
    #   or a KernelBundle (both immutable release artifacts)
    default_score_missing: bool = False  # True on warm hits whose stored
    #   record carries no default_score (written by rank_space with the
    #   centre config outside the enumeration limit): default_score is NaN
    #   then, and JSON emitters must treat it as absent


def _score_config(space: Space, target: HardwareTarget, cfg: Dict) -> float:
    prog, meta = space.instantiate(cfg)
    return cost_model.evaluate(prog, target, meta)


def tune(
    space: Space,
    target: HardwareTarget,
    iterations: int = 12,
    population: int = 16,
    seed: int = 0,
    workers: int = 8,
    db=None,
) -> TuneResult:
    """ES search (Alg. 4) over ``space`` with the static score as fitness;
    each distinct config is scored once. A warm store hit returns with
    **zero** cost-model evaluations; a miss is written back under strategy
    ``es``."""
    t0 = time.perf_counter()
    if db is not False:  # False = full bypass, snapshot cache included
        rec, source = _lookup(space.signature(), target.name,
                              COST_MODEL_VERSION, db)
        if rec is not None:
            has_default = "default_score" in rec.meta
            return TuneResult(
                config=dict(rec.config),
                score=rec.score,
                evaluations=0,
                wall_seconds=time.perf_counter() - t0,
                history=[],
                default_score=float(
                    rec.meta.get("default_score", float("nan"))),
                from_db=True,
                from_cache=source in ("cache", "bundle"),
                default_score_missing=not has_default,
            )

    store = resolve_db(db)  # the miss path only: a snapshot hit must not
    #                         pay a JSONL log load
    cache: Dict[Tuple, float] = {}

    def fitness(theta: np.ndarray) -> float:
        cfg = space.decode(theta)
        key = tuple(sorted(cfg.items()))
        if key not in cache:
            cache[key] = _score_config(space, target, cfg)
        return -cache[key]

    res = es.evolve(
        fitness,
        dim=space.dim,
        iterations=iterations,
        population=population,
        seed=seed,
        workers=workers,
    )
    best_cfg = space.decode(res.best_theta)
    best_score = _score_config(space, target, best_cfg)
    result = TuneResult(
        config=best_cfg,
        score=best_score,
        evaluations=res.evaluations,
        wall_seconds=time.perf_counter() - t0,
        history=res.history,
        default_score=_score_config(space, target, space.default_config()),
    )
    if _writable(store):
        from repro_torch.tuna.db import ScheduleRecord, stamp_tuned_at

        store.add(ScheduleRecord(
            op=space.signature(),
            target=target.name,
            config=dict(best_cfg),
            score=best_score,
            evaluations=res.evaluations,
            meta=stamp_tuned_at(
                {"strategy": "es", "default_score": result.default_score}),
        ))
    return result


def rank_space(space: Space, target: HardwareTarget, limit: int = 4096,
               db=False) -> List[Tuple[Dict, float]]:
    """Static exhaustive ranking (ascending score = predicted fastest first).

    Callers need the full ranking, which the store does not hold, so this
    is a *write-back* integration: when a store resolves, the winning
    record is appended under strategy ``exhaustive`` (``best_schedule`` is
    the read path)."""
    scored = [(cfg, _score_config(space, target, cfg))
              for cfg in space.enumerate(limit)]
    scored.sort(key=lambda cs: cs[1])
    store = resolve_db(db)
    if _writable(store) and scored:
        from repro_torch.tuna.db import ScheduleRecord, stamp_tuned_at

        meta = {"strategy": "exhaustive", "limit": limit}
        dflt = space.default_config()
        default_score = next((s for c, s in scored if c == dflt), None)
        if default_score is not None:  # centre config inside the limit
            meta["default_score"] = default_score
        store.add(ScheduleRecord(
            op=space.signature(),
            target=target.name,
            config=dict(scored[0][0]),
            score=scored[0][1],
            evaluations=len(scored),
            meta=stamp_tuned_at(meta),
        ))
    return scored


def best_schedule(space: Space, target: HardwareTarget, limit: int = 1024,
                  db=None) -> Tuple[Dict, float]:
    """Best (config, score) for a space: a snapshot-cache or DB hit costs
    zero evaluations; a miss ranks the space exhaustively and writes the
    winner back (to a writable store only). The block pickers sit on this."""
    if db is not False:
        rec = lookup_best(space.signature(), target.name, db=db)
        if rec is not None:
            return dict(rec.config), rec.score
    store = resolve_db(db)  # miss path only, like tune()
    ranked = rank_space(space, target, limit=limit,
                        db=store if _writable(store) else False)
    if not ranked:
        raise ValueError(f"{space.signature()}: the schedule space on "
                         f"{target.name} is empty")
    return ranked[0]


@functools.lru_cache(maxsize=256)
def tuned_matmul_blocks(M: int, N: int, K: int,
                        dtype_bytes: int = 2) -> Tuple[int, int, int, bool]:
    """Statically tuned (bm, bn, bk, double_buffer) for the Hopper matmul
    kernel, memoised per shape.

    Exhaustive over the ``sm90`` matmul space on ``GPU_H100``, whose knobs
    are exactly the tiles the kernel is built for that divide the shape:
    no card is read, as the paper requires. Consults the default snapshot
    and DB first (``best_schedule``), so a warm store makes this a pure
    lookup. Raises ``ValueError`` when no built tile divides one of M, N,
    K."""
    space = MatmulSpace(M, N, K, dtype_bytes, target_kind=GPU_H100.kind)
    best, _ = best_schedule(space, GPU_H100, limit=1024)
    return best["bm"], best["bn"], best["bk"], best["double_buffer"]
