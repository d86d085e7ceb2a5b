"""One-shot coefficient calibration (paper §III: "coefficients a_0..a_n are
generated for each hardware architecture through hardware instruction latency
and empirical profiling data").

The port's own copy of ``repro.core.calibrate``, held against it by
``tests/test_torch_learned.py``. A small probe set (one shape, 16
schedules, seed 123, disjoint from the evaluation seeds) is measured ONCE
per target and card; a non-negative least-squares fit maps the static
features to seconds. The fitted coefficients are then reused for every
shape on that card: search itself stays fully static, only the a_i change.

Two targets are fitted:

  * ``cpu_avx2`` at the reference's 256³ probe, f32, through the plain
    version on the host (``benchmarks.measure.measure_config``). This is
    plumbing: the reference realises every knob of a ``cpu`` config as an
    XLA loop of block dots, while the port's plain version runs only the K
    slices, so its times ignore ``order``, ``unroll_i``, ``bm`` and ``bn``.
  * ``gpu_h100`` at a probe of 4096×2048×4096 in bf16, through the Hopper
    matmul kernel timed by CUDA-graph replay: a shape that is not one of
    the yi-6b projections the top-k ratio scores, that every built tile
    divides (so the whole ``sm90`` space of 24 configs is the pool) and
    that keeps each launch well above the launch overhead.

Each design-matrix row enters as ``cost_model.score`` combines it: the
per-core terms divided by the exploitable parallelism
``min(num_cores, parallel_extent)``, the memory-traffic term not. On
``cpu_avx2`` (one core) that divisor is 1 and the fit is the reference's
exactly; on the H100 (132 SMs) it keeps the fitted seconds the seconds the
score predicts.

Fits are cached as JSON under ``build/calibration/`` (which ``.gitignore``
lists), one file per target and card; the reference's
``experiments/cpu_calibration.json`` is read by tests only, never written.
Unlike the reference's ``cached_cpu_coeffs``, a failed fit raises: a
calibrated ranking on the card uses a fit of the card or none at all.
"""
from __future__ import annotations

import json
import math
import os
import platform
import re
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.spaces import MatmulSpace
from repro_torch.hw import DEFAULT_TARGET, get_target, resolve_device

FEATURES = ("ilp_cycles", "movement_bytes", "arith_ops", "ldst_ops",
            "dispatch_calls")
_PER_CORE = ("ilp_cycles", "arith_ops", "ldst_ops", "dispatch_calls")

# target -> (probe (M, N, K), dtype bytes, device type it is measured on)
PROBES: Dict[str, Tuple[Tuple[int, int, int], int, str]] = {
    "cpu_avx2": ((256, 256, 256), 4, "cpu"),
    "gpu_h100": ((4096, 2048, 4096), 2, "cuda"),
}
PROBE_SEED = 123  # disjoint from the evaluation sample seeds
CALIBRATION_DIR = Path(__file__).resolve().parents[3] / "build" / "calibration"


def _nnls(A: np.ndarray, y: np.ndarray, iters: int = 2000) -> np.ndarray:
    """Projected-gradient NNLS (numpy only)."""
    x = np.zeros(A.shape[1])
    At = A.T
    L = np.linalg.norm(A, 2) ** 2 + 1e-12
    for _ in range(iters):
        x = np.maximum(0.0, x - (At @ (A @ x - y)) / L)
    return x


def fit_coefficients(
    target_name: str = DEFAULT_TARGET,
    device=None,
    probe: Optional[Tuple[int, int, int]] = None,
    n_configs: int = 16,
    iters: int = 10,
    seed: int = PROBE_SEED,
    db=None,
) -> Dict[str, float]:
    """Measure ``n_configs`` configs of ``target_name``'s matmul space at
    the probe on ``device`` (by default the device the target is measured
    on: the card for ``gpu_h100``), fit per-feature seconds. ``db`` (a
    ``ScheduleDatabase`` or path) also receives every probe measurement as
    a ``cm1-meas`` record, training data for the learned ranker.

    Returns the coefficients of ``FEATURES``, ``intercept``,
    ``_r2_on_probe`` and the fit's provenance (``_target``, ``_card``,
    ``_probe``, ``_n_configs``, ``_seed``). Raises ``ValueError`` when a
    coefficient is not finite."""
    import torch

    from repro_torch.benchmarks import measure
    from repro_torch.benchmarks.topk_ratio import sample_space

    if target_name not in PROBES:
        raise KeyError(f"no calibration probe for target {target_name!r}; "
                       f"have {sorted(PROBES)}")
    default_probe, dtype_bytes, measured_on = PROBES[target_name]
    dev = resolve_device(device or measured_on)
    target = get_target(target_name)
    M, N, K = probe or default_probe
    space = MatmulSpace(M, N, K, dtype_bytes, target_kind=target.kind)
    cfgs = sample_space(space, n_configs, seed)
    if not cfgs:
        raise ValueError(f"{space.signature()}: the probe's space is empty")

    dtype = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
    rows: List[List[float]] = []
    ys: List[float] = []
    for cfg in cfgs:
        prog, meta = space.instantiate(cfg)
        f = cost_model.extract_features(prog, target, meta)
        par = min(target.num_cores, max(1, f.parallel_extent))
        rows.append([getattr(f, name) / (par if name in _PER_CORE else 1)
                     for name in FEATURES] + [1.0])
        ys.append(measure.measure_config(a, b, cfg, iters=iters))
    if db is not None:
        _collect(db, space, target, cfgs, ys, iters)

    A = np.asarray(rows)
    y = np.asarray(ys)
    scale = A.max(axis=0)
    scale[scale == 0] = 1.0
    x = _nnls(A / scale, y)
    coef = x / scale
    out = {name: float(c) for name, c in zip(FEATURES, coef)}
    out["intercept"] = float(coef[-1])
    pred = A @ coef
    ss = 1.0 - np.sum((pred - y) ** 2) / max(np.sum((y - y.mean()) ** 2), 1e-12)
    out["_r2_on_probe"] = float(ss)
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise ValueError(f"{target_name} fit is not finite: {bad}")
    out.update(_target=target_name, _card=card_name(dev), _probe=[M, N, K],
               _n_configs=len(cfgs), _seed=seed)
    return out


def _collect(db, space, target, cfgs, seconds, iters) -> None:
    from repro_torch.core.learned import measured_version
    from repro_torch.core.tuner import resolve_db
    from repro_torch.tuna.db import ScheduleRecord, stamp_tuned_at

    store = resolve_db(db)
    for cfg, s in zip(cfgs, seconds):
        store.add(ScheduleRecord(
            op=space.signature(), target=target.name, config=dict(cfg),
            score=float(s), evaluations=iters,
            meta=stamp_tuned_at({"strategy": "calibration_probe",
                                 "iters": iters}),
            version=measured_version()))


def fit_cpu_coefficients(
    probe: Tuple[int, int, int] = (256, 256, 256),
    n_configs: int = 16,
    iters: int = 3,
    seed: int = PROBE_SEED,
) -> Dict[str, float]:
    """The reference's host fit: ``cpu_avx2`` at 256³ through the plain
    version on the CPU (see the module docstring: plumbing)."""
    return fit_coefficients("cpu_avx2", "cpu", probe=probe,
                            n_configs=n_configs, iters=iters, seed=seed)


def coeffs_for_scoring(fitted: Dict[str, float]) -> Dict[str, float]:
    """Convert a fit into the cost_model.score coefficient dict."""
    base = dict(
        ilp_cycles=fitted["ilp_cycles"],
        movement_bytes=fitted["movement_bytes"],
        arith_ops=fitted["arith_ops"],
        ldst_ops=fitted["ldst_ops"],
        dispatch_calls=fitted.get("dispatch_calls", 0.0),
        unhidden_dma_cycles=0.0,
        alignment_waste=1e-6,
        occupancy_penalty=1e-6,
        vmem_overflow=1.0,
        parallel_extent=0.0,
    )
    return base


def card_name(device) -> str:
    """What a fit is keyed by besides its target: the card's name, or the
    host's machine type for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        return torch.cuda.get_device_name(dev)
    return f"cpu-{platform.machine() or 'unknown'}"


def cache_path(target_name: str, device) -> Path:
    slug = re.sub(r"[^A-Za-z0-9]+", "-", card_name(device)).strip("-")
    return CALIBRATION_DIR / f"{target_name}.{slug}.json"


def cached_coeffs(target_name: str = DEFAULT_TARGET, device=None,
                  refit: bool = False, **fit_kw) -> Dict[str, float]:
    """The cached fit of ``target_name`` on this card, fitted (and cached)
    when there is none or ``refit``. ``fit_kw`` go to ``fit_coefficients``.
    Every failure raises: nothing falls back to data-sheet coefficients."""
    dev = resolve_device(device or PROBES[target_name][2])
    path = cache_path(target_name, dev)
    if not refit and path.exists():
        with open(path) as f:
            return json.load(f)
    fitted = fit_coefficients(target_name, dev, **fit_kw)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(fitted, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return fitted
