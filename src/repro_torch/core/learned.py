"""Learned schedule ranker trained offline from the JSONL schedule store.

The port's own copy of ``repro.core.learned``, held against it by
``tests/test_torch_learned.py``: on the same store it builds the same
feature rows (``FEATURE_NAMES`` equal, in order), fits the same weights and
so the same fingerprint, and its artifacts load in either package.

The static ``cm1`` model ranks without touching hardware; the fleet's store
accumulates exactly the (op signature, config, score) pairs that learned
cost models train on (TLP; the TPU learned performance model). This module
is the numpy-only counterpart: a ridge regression in log space over

  * the ``cm1`` static feature vector (``cost_model.extract_features`` —
    ILP makespan, locality traffic, ``core.instcount`` instruction counts,
    alignment/occupancy/overflow penalties),
  * the schedule's config-dict knobs (log2 block sizes, loop order,
    unroll, double-buffering), and
  * graph-level HLO counts, zeros for TIR-space records (no record of
    either package carries ``meta["hlo"]``; the port has no HLO parser).

**Lineages.** Stored scores are only comparable within one
``record_version`` lineage: datasheet ``cm1`` predictions, host-calibrated
``cm1-cal-<fp>`` fits, and measured ``cm1-meas`` samples live on different
scales. Training therefore standardises targets *per lineage* — every
lineage contributes rank information, no lineage's scale leaks into
another's — and the artifact records which lineages (and how many samples)
it saw. Records written by a learned ranker itself (version containing
``+lr``) are excluded: a model must never train on its own write-backs.

**Serving.** ``core.tuner.rank_space``/``best_schedule`` serve the model as
a hybrid: static ``cm1`` scores and prunes the space, the model re-ranks
the top-K candidates (``LearnedRanker.rerank``) — zero hardware
measurements at ranking time. Hybrid write-backs carry the version
``<base>+lr<fp>`` so they never collide with pure static records.

**Artifact.** ``save_ranker``/``load_ranker`` persist the model as JSON
(schema ``tuna-learned-v1``): the payload is sha1-digested
(content-addressed, torn copies fail loudly), the parameters are
fingerprinted (``fingerprint`` = sha1 over the canonical parameter set, the
``<fp>`` in the version tag) and re-verified at load, and a model built
under a different ``COST_MODEL_VERSION`` raises ``StaleSnapshotError``
exactly like stale snapshots/bundles — never silently served.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost_model, op_registry
from repro_torch.core.cost_model import COST_MODEL_VERSION
from repro_torch.core.op_registry import Space
from repro_torch.hw.target import HardwareTarget

LEARNED_SCHEMA = "tuna-learned-v1"
LEARNED_POINTER_SCHEMA = "tuna-learned-pointer-v1"

# Static cm1 features folded into the learned vector (log1p-compressed:
# they span ~9 orders of magnitude across shapes).
_STATIC_LOG = ("ilp_cycles", "movement_bytes", "unhidden_dma_cycles",
               "arith_ops", "ldst_ops", "dispatch_calls", "parallel_extent",
               "vmem_overflow")
_STATIC_RAW = ("alignment_waste", "occupancy_penalty")
# Config-dict knob features (0 when a space has no such knob): the union of
# every registered OpDef's declared KnobFeatures, group-major (log2 tile
# sizes | raw counts | flags | choice one-hots). Legacy families register
# first, so the historical column layout is a stable prefix and new op
# families extend each group; models saved under an older layout are
# re-aligned by name at predict time.
KNOB_FEATURES = op_registry.knob_feature_union()
# Graph-level hlo_features counts (records carrying meta["hlo"]).
_HLO_COUNTS = ("n_fusions", "n_dots", "n_layout_ops", "n_while")

FEATURE_NAMES: Tuple[str, ...] = (
    tuple(f"log_{n}" for n in _STATIC_LOG)
    + _STATIC_RAW
    + tuple(n for kf in KNOB_FEATURES for n in kf.feature_names())
    + tuple(f"hlo_{n}" for n in _HLO_COUNTS)
)


def featurize(space: Space, target: HardwareTarget, cfg: Dict,
              hlo_text: Optional[str] = None) -> np.ndarray:
    """Feature vector for one (space, config) candidate — purely static:
    TIR instantiation + VISA lowering (``core.instcount`` runs inside
    ``extract_features``), the config dict itself, and optional HLO-text
    counts. Never touches hardware."""
    prog, meta = space.instantiate(cfg)
    f = cost_model.extract_features(prog, target, meta).as_dict()
    row: List[float] = [math.log1p(max(0.0, float(f[n])))
                        for n in _STATIC_LOG]
    row += [float(f[n]) for n in _STATIC_RAW]
    for kf in KNOB_FEATURES:
        v = cfg.get(kf.name)
        if kf.kind == "log2":
            row.append(math.log2(v) if isinstance(v, (int, float)) and v > 0
                       else 0.0)
        elif kf.kind == "raw":
            row.append(float(v or 0))
        elif kf.kind == "flag":
            row.append(1.0 if v else 0.0)
        else:  # choice one-hot
            row += [1.0 if v == c else 0.0 for c in kf.choices]
    row += list(hlo_counts(hlo_text))
    return np.asarray(row, dtype=np.float64)


def hlo_counts(hlo_text: Optional[str]) -> Tuple[float, ...]:
    """Graph-level sub-vector from ``core.hlo_features.parse_hlo`` —
    zeros when no HLO text is attached (TIR-space records)."""
    if not hlo_text:
        return (0.0,) * len(_HLO_COUNTS)
    from repro_torch.core.hlo_features import parse_hlo

    hf = parse_hlo(hlo_text)
    return tuple(float(getattr(hf, n)) for n in _HLO_COUNTS)


# -- op-signature round trip -------------------------------------------------


def space_from_signature(sig: str,
                         target: HardwareTarget) -> Optional[Space]:
    """Reconstruct the schedule space a record's op signature came from
    (inverse of ``Space.signature``), via the operator registry. None for
    op families the registry does not know (e.g. graph-level ``cell[...]``
    records) — those rows are skipped by the trainer, they don't fail it."""
    return op_registry.space_from_signature(sig, target.kind)


def lineage_of(version: str) -> str:
    """The score lineage a record's version tag names. Distinct lineages
    (datasheet, per-host calibrated fits, measured samples) carry
    incomparable score scales and are standardised separately."""
    return version


def measured_version() -> str:
    """Version tag for measured per-config sample records (what
    ``repro_torch.benchmarks.topk_ratio --collect`` appends): its own lineage, so
    measured seconds never compare against static scores, and the ``-meas``
    suffix keeps them from ever warm-hitting as search-grade records."""
    return f"{COST_MODEL_VERSION}-meas"


# -- the model ---------------------------------------------------------------

@dataclasses.dataclass
class LearnedRanker:
    """Ridge regression over ``FEATURE_NAMES`` predicting standardised
    log score — rank information only (scale-free by construction)."""

    weights: np.ndarray
    bias: float
    mean: np.ndarray
    std: np.ndarray
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    cost_model_version: str = COST_MODEL_VERSION
    lineages: Dict[str, int] = dataclasses.field(default_factory=dict)
    l2: float = 1e-2
    built_at: Optional[float] = None

    def params(self) -> Dict:
        """Canonical parameter set — exactly what the fingerprint covers."""
        return {
            "weights": [float(w) for w in np.asarray(self.weights).ravel()],
            "bias": float(self.bias),
            "mean": [float(v) for v in np.asarray(self.mean).ravel()],
            "std": [float(v) for v in np.asarray(self.std).ravel()],
            "feature_names": list(self.feature_names),
            "cost_model_version": self.cost_model_version,
            "lineages": {k: int(v) for k, v in sorted(self.lineages.items())},
            "l2": float(self.l2),
        }

    def fingerprint(self) -> str:
        blob = json.dumps(self.params(), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()

    def hybrid_version(self, base: Optional[str] = None) -> str:
        """Record-version tag for hybrid (cm1-prune + learned-rerank)
        results: ``<base>+lr<fp8>`` — its own lineage, mirroring
        ``record_version``'s calibrated fingerprinting."""
        return f"{base or self.cost_model_version}+lr{self.fingerprint()[:8]}"

    @property
    def version(self) -> str:
        return self.hybrid_version(self.cost_model_version)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = self._align(np.atleast_2d(np.asarray(X, dtype=np.float64)))
        Z = (X - self.mean) / self.std
        return Z @ self.weights + self.bias

    def _align(self, X: np.ndarray) -> np.ndarray:
        """Project rows laid out as today's ``FEATURE_NAMES`` onto the
        layout this model was trained with. Registering a new op family
        inserts knob columns; a model from before the registration keeps
        working — its known columns are matched by name, its unknown ones
        (none, for an insert-only change) read as zero."""
        if self.feature_names == FEATURE_NAMES:
            return X
        if X.shape[1] != len(FEATURE_NAMES):
            return X  # caller already built rows in the model's own layout
        idx = {n: i for i, n in enumerate(FEATURE_NAMES)}
        out = np.zeros((X.shape[0], len(self.feature_names)))
        for j, name in enumerate(self.feature_names):
            i = idx.get(name)
            if i is not None:
                out[:, j] = X[:, i]
        return out

    def score_config(self, space: Space, target: HardwareTarget,
                     cfg: Dict) -> float:
        return float(self.predict(featurize(space, target, cfg))[0])

    def rerank(self, space: Space, target: HardwareTarget,
               ranked: Sequence[Tuple[Dict, float]],
               top: int = 32) -> List[Tuple[Dict, float]]:
        """Hybrid step: re-order the first ``top`` statically-ranked
        (config, static_score) candidates by learned prediction; the
        pruned tail keeps its static order. Scores in the returned pairs
        stay the static ones (the stored lineage is explicit about what a
        score means)."""
        ranked = list(ranked)
        k = max(0, min(int(top), len(ranked)))
        if k < 2:
            return ranked
        head = ranked[:k]
        X = np.stack([featurize(space, target, cfg) for cfg, _ in head])
        preds = self.predict(X)
        idx = sorted(range(k), key=lambda i: (preds[i], head[i][1]))
        return [head[i] for i in idx] + ranked[k:]


def fit_ranker(X: np.ndarray, y: np.ndarray,
               lineage_ids: Sequence[str],
               l2: float = 1e-2) -> LearnedRanker:
    """Ridge fit on standardised features vs per-lineage-standardised log
    targets. Lineages with a single sample contribute nothing after
    centring (their target becomes 0) but cost nothing either."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if X.ndim != 2 or len(X) != len(y) or len(y) == 0:
        raise ValueError(f"bad training set: X{X.shape} y{y.shape}")
    logy = np.log(np.maximum(y, 1e-30))
    t = np.zeros_like(logy)
    counts: Dict[str, int] = {}
    for lin in sorted(set(lineage_ids)):
        m = np.asarray([li == lin for li in lineage_ids])
        counts[lin] = int(m.sum())
        mu = logy[m].mean()
        sd = logy[m].std()
        t[m] = (logy[m] - mu) / (sd if sd > 1e-12 else 1.0)
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std[std < 1e-12] = 1.0
    Z = (X - mean) / std
    A = Z.T @ Z + l2 * len(y) * np.eye(Z.shape[1])
    w = np.linalg.solve(A, Z.T @ t)
    return LearnedRanker(weights=w, bias=float(t.mean() - (Z @ w).mean()),
                         mean=mean, std=std, lineages=counts, l2=float(l2))


# -- artifact persistence ----------------------------------------------------

def _params_sha1(params: Dict) -> str:
    return hashlib.sha1(
        json.dumps(params, sort_keys=True, default=float).encode()
    ).hexdigest()


def save_ranker(model: LearnedRanker, path: str) -> str:
    """Write the model artifact (atomic temp-file + replace). Header
    fields (schema, version, fingerprint, sha1) come before the parameter
    payload; ``built_at`` sits outside the digests so re-saving identical
    parameters keeps the same content address. Returns the payload sha1."""
    params = model.params()
    fp = model.fingerprint()
    sha1 = _params_sha1(params)
    model.built_at = round(time.time(), 3)
    obj = {
        "schema": LEARNED_SCHEMA,
        "cost_model_version": model.cost_model_version,
        "version": model.version,
        "fingerprint": fp,
        "sha1": sha1,
        "built_at": model.built_at,
        "model": params,
    }
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".learned.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return sha1


def load_ranker(path: str) -> LearnedRanker:
    """Load + verify a model artifact; follows a ``latest`` pointer.

    Raises ``ValueError`` on schema mismatch, payload-digest corruption
    (torn transport copies), or a parameter-fingerprint mismatch (the
    ``+lr<fp>`` in the version tag no longer names these weights), and
    ``repro_torch.tuna.cache.StaleSnapshotError`` when the model was trained
    under a different ``COST_MODEL_VERSION`` — its features and training
    scores would silently mean something else."""
    path = os.fspath(path)
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if isinstance(obj, dict) and obj.get("schema") == LEARNED_POINTER_SCHEMA:
        target = os.path.join(os.path.dirname(os.path.abspath(path)),
                              obj["artifact"])
        return load_ranker(target)
    if not isinstance(obj, dict) or obj.get("schema") != LEARNED_SCHEMA:
        schema = obj.get("schema") if isinstance(obj, dict) else None
        raise ValueError(f"{path}: not a learned-ranker artifact "
                         f"(schema={schema!r}, want {LEARNED_SCHEMA!r})")
    params = obj.get("model") or {}
    if _params_sha1(params) != obj.get("sha1"):
        raise ValueError(f"{path}: learned-model digest mismatch (corrupt "
                         f"or torn copy); retrain with "
                         f"`python -m repro_torch.tuna train`")
    model = LearnedRanker(
        weights=np.asarray(params["weights"], dtype=np.float64),
        bias=float(params["bias"]),
        mean=np.asarray(params["mean"], dtype=np.float64),
        std=np.asarray(params["std"], dtype=np.float64),
        feature_names=tuple(params["feature_names"]),
        cost_model_version=str(params["cost_model_version"]),
        lineages=dict(params.get("lineages", {})),
        l2=float(params.get("l2", 1e-2)),
        built_at=obj.get("built_at"),
    )
    if model.fingerprint() != obj.get("fingerprint"):
        raise ValueError(
            f"{path}: learned-model fingerprint mismatch — the stored "
            f"version tag {obj.get('version')!r} does not name these "
            f"parameters (tampered or mis-assembled artifact); retrain "
            f"with `python -m repro_torch.tuna train`")
    if model.cost_model_version != COST_MODEL_VERSION:
        from repro_torch.tuna.cache import StaleSnapshotError

        raise StaleSnapshotError(
            f"{path}: learned model was trained under cost-model version "
            f"{model.cost_model_version!r} but this process runs "
            f"{COST_MODEL_VERSION!r}; its features and training scores no "
            f"longer mean the same thing. Retrain it: "
            f"`python -m repro_torch.tuna train`")
    return model


def spearman(a: Iterable[float], b: Iterable[float]) -> float:
    """Spearman rank correlation (numpy-only) — the eval metric: a ranker
    is judged on ordering, not on absolute score scale."""
    a = np.asarray(list(a), dtype=np.float64)
    b = np.asarray(list(b), dtype=np.float64)
    if len(a) < 2:
        return 0.0
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    sa, sb = ra.std(), rb.std()
    if sa < 1e-12 or sb < 1e-12:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))
