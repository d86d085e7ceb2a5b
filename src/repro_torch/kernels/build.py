"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/kernels/<name>-<digest>.so`` at the root of
the checkout (a directory ``.gitignore`` lists), then loaded with ``ctypes``.
Sources that need building are compiled in parallel, one ``nvcc`` each.
The digest covers the sources and the flags, so an edited kernel is rebuilt
and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        found = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


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
        running[n] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for n, (proc, tmp, lib, t0) in running.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        log_path(n).write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
