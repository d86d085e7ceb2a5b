"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own (with the ``csrc/*.cuh`` headers it includes) into
``build/kernels/<name>-<digest>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), then loaded with ``ctypes``.
Sources that need building are compiled in parallel, one ``nvcc`` each.
The digest covers the sources and the flags, so an edited kernel is rebuilt
and an unchanged one is reused.

A prebuilt library can be installed for a source name (``install``: a
kernel bundle's copy, verified and written under ``build/``); ``load`` then
opens it and builds nothing. ``NVCC_RUNS`` counts the ``nvcc`` processes
this process started, per source: the witness that a start served from a
bundle compiled nothing (a launch count cannot say whether a build came
first). Installing or removing a library clears ``load``'s memo and the
kernel wrappers' handles (``register_load_clearer``), so the next launch
opens the library now in place.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# one library per source; the 16-bit kernels' templates are in the
# ``.cuh`` headers, instantiated per dtype and width across the sources so
# that no one nvcc carries them all
SOURCES = ("flash_attention", "flash_attention_f16", "flash_attention_wide",
           "flash_attention_chunked", "matmul", "matmul_f16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# nvcc processes started in this process, per source
NVCC_RUNS: Dict[str, int] = {n: 0 for n in SOURCES}
# prebuilt libraries installed per source name; load() opens these unbuilt
_INSTALLED: Dict[str, Path] = {}
# memo clearers of the handles onto load()'s libraries (the kernel wrappers')
_LOAD_CLEARERS: List[Callable[[], None]] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        found = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def source_digest() -> str:
    """The digest of every kernel source (``csrc/*.cu*``) and the flags:
    what a built library's file name carries, and what a kernel bundle
    records so that a binary built from other sources never serves."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest()}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source in ``names`` (default: all) that is not built
    yet, all at once. Returns the seconds each build took (0.0 when the
    library was already there); raises with the compiler's log on failure."""
    secs = {}
    running = {}
    for n in (SOURCES if names is None else names):
        secs[n] = 0.0
        lib = library_path(n)
        if lib.exists():
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        NVCC_RUNS[n] = NVCC_RUNS.get(n, 0) + 1
        running[n] = (proc, tmp, lib, time.perf_counter())
    # each source's own seconds: one waiter thread per nvcc, so that a
    # source is timed when it ends, not when the ones before it were read
    outs: Dict[str, str] = {}

    def wait(n: str, proc, t0: float) -> None:
        outs[n], _ = proc.communicate()
        secs[n] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(n, proc, t0))
               for n, (proc, _, _, t0) in running.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for n, (proc, tmp, lib, _) in running.items():
        log_path(n).write_text(outs[n])
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}:\n{outs[n]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def register_load_clearer(fn: Callable[[], None]) -> None:
    _LOAD_CLEARERS.append(fn)


def _clear_loaded() -> None:
    load.cache_clear()
    for fn in _LOAD_CLEARERS:
        fn()


def install(name: str, path) -> None:
    """Serve ``csrc/<name>.cu`` from the prebuilt library at ``path``: the
    next ``load(name)`` opens it and builds nothing."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; have {SOURCES}")
    _INSTALLED[name] = Path(path)
    _clear_loaded()


def uninstall(name: str) -> None:
    """Back to the library built from this checkout's sources."""
    if _INSTALLED.pop(name, None) is not None:
        _clear_loaded()


def installed() -> Dict[str, Path]:
    """The prebuilt libraries installed, by source name."""
    return dict(_INSTALLED)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``: the installed prebuilt one, else
    the one built from the sources, building it first if needed."""
    path = _INSTALLED.get(name)
    if path is None:
        build([name])
        path = library_path(name)
    return ctypes.CDLL(str(path))
