"""repro_torch.tuna — persistent schedule database + distributed tuning fleet.

The port's own copy of ``repro.tuna``, over the port's targets
(``gpu_h100``): ``db`` persists ``cm1`` schedule records keyed by (op
signature, target, cost-model version); ``orchestrator`` fans tuning jobs
over a process pool; ``fleet`` shards the job matrix across hosts and
reconciles per-shard stores; ``transport`` moves shard stores and
snapshots between hosts over manifest-verified channels; ``cache``
compiles the store into an immutable serving-time snapshot and manages its
lifecycle (``SnapshotManager``: versioned names, a ``latest`` pointer,
publish); ``cli`` drives it (``python -m repro_torch.tuna``).
``core.tuner`` consults the snapshot and the DB transparently and
hot-reloads republished snapshots via ``refresh_default_cache``. The files
are the reference's: either package reads what the other writes.

The reference's fleet controller, golden releases and kernel bundles, and
learned ranker wait for ROADMAP Queue A 4 and 9.

Only ``db``, ``cache``, and ``transport`` are imported eagerly
(``orchestrator``/``fleet`` pull in the operator registry).
"""
from repro_torch.tuna.cache import (
    ScheduleCache,
    SnapshotManager,
    StaleSnapshotError,
)
from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord, SCHEMA
from repro_torch.tuna.transport import (
    LocalDirTransport,
    MemoryTransport,
    Transport,
    resolve_transport,
)

__all__ = [
    "LocalDirTransport",
    "MemoryTransport",
    "ScheduleCache",
    "ScheduleDatabase",
    "ScheduleRecord",
    "SCHEMA",
    "SnapshotManager",
    "StaleSnapshotError",
    "Transport",
    "resolve_transport",
]
