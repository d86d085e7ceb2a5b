"""repro_torch.tuna — persistent schedule database + distributed tuning fleet.

The port's own copy of ``repro.tuna``, over the port's targets
(``gpu_h100``, and the reference's three): ``db`` persists ``cm1`` schedule records keyed by (op
signature, target, cost-model version); ``orchestrator`` fans tuning jobs
over a process pool; ``fleet`` shards the job matrix across hosts and
reconciles per-shard stores; ``transport`` moves shard stores and
snapshots between hosts over manifest-verified channels; ``cache``
compiles the store into an immutable serving-time snapshot and manages its
lifecycle (``SnapshotManager``: versioned names, a ``latest`` pointer,
publish); ``golden`` freezes the store into regression-gated golden
releases and builds kernel bundles that carry the compiled Hopper
libraries; ``learned`` trains the learned ranker from the store's log
(``train_from_store``) and keeps its artifacts (``LearnedManager``);
``controller`` runs the whole fleet as a daemon — lease-tracked shard
dispatch, crash healing, sync + verify, snapshot (and learned-ranker)
republish, and an HTTP schedule/health/metrics API (``python -m
repro_torch.tuna controller``); ``cli`` drives it (``python -m
repro_torch.tuna``).
``core.tuner`` consults an installed bundle, the snapshot and the DB
transparently and hot-reloads republished snapshots via
``refresh_default_cache``. The store, snapshot and golden-release files
are the reference's: either package reads what the other writes. Kernel
bundles are not: each package refuses the other's by its backend tag.
Learned-ranker artifacts are: a ranker trained by either package on the
same store has the same fingerprint.

Only ``db``, ``cache``, ``golden`` and ``transport`` are imported eagerly
(``orchestrator``/``fleet`` pull in the operator registry; ``golden``
imports torch only inside its bundle functions).
"""
from repro_torch.tuna.cache import (
    ScheduleCache,
    SnapshotManager,
    StaleSnapshotError,
)
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord, SCHEMA
from repro_torch.tuna.golden import (
    BundleError,
    GoldenError,
    GoldenManager,
    GoldenRegressionError,
    KernelBundle,
    build_kernel_bundle,
)
from repro_torch.tuna.transport import (
    LocalDirTransport,
    MemoryTransport,
    Transport,
    resolve_transport,
)

__all__ = [
    "BundleError",
    "GoldenError",
    "GoldenManager",
    "GoldenRegressionError",
    "KernelBundle",
    "LocalDirTransport",
    "MemoryTransport",
    "ScheduleCache",
    "ScheduleDatabase",
    "ScheduleRecord",
    "SCHEMA",
    "SnapshotManager",
    "StaleSnapshotError",
    "Transport",
    "build_kernel_bundle",
    "resolve_transport",
]
