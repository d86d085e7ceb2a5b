"""Checkpoint store: per-leaf .npy files + a JSON manifest, atomic, keep-k
(the port of ``repro.checkpoint.store``, in its layout):

    <dir>/step_00000100/
        manifest.json     # tree structure, leaf paths, dtypes, shapes, step, meta
        leaf_00000.npy    # one file per tree leaf (the whole tensor)
        ...
    <dir>/LATEST          # atomic pointer file

Writes go to ``step_X.tmp`` then ``os.rename``, so a crash mid-write never
corrupts a visible checkpoint. Leaves are numbered in the reference's
flatten order (dict keys sorted, ``repro_torch.tree``), so a checkpoint of an
f32 model written by either package restores in the other.

numpy has no bfloat16. A bf16 leaf is stored as its raw 16-bit patterns in a
2-byte void array (``'<V2'``, what numpy writes for the reference's
``ml_dtypes`` bf16 arrays too) with ``"dtype": "bfloat16"`` in the manifest;
``restore`` reads the patterns back into a bf16 tensor, bit for bit, with no
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf whole: a ``DTensor`` gathered from its mesh (a collective:
    every rank of the mesh calls it), a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf; bf16 as its 16-bit patterns in a ``'<V2'``
    array."""
    t = _whole(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    """The stored leaf as a tensor on ``like``'s device (bf16 from its bit
    patterns)."""
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(arr).to(like.device)


def save(directory: str, step: int, tree, meta: Optional[Dict] = None) -> str:
    """Write ``tree`` (of tensors) as checkpoint ``step``. ``DTensor``
    leaves are stored whole; under a process group every rank calls this
    and rank 0 writes."""
    if not _writer():
        for leaf in tree_mod.leaves(tree):
            _whole(leaf)
        return os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = tree_mod.leaves(tree)
    manifest = {
        "step": step,
        "treedef": tree_mod.structure(tree),
        "paths": tree_mod.paths(tree),
        "leaves": [],
        "meta": meta or {},
    }
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append(
            {"index": i, "shape": list(arr.shape),
             "dtype": str(leaf.dtype).removeprefix("torch.")})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(directory: str, tree_like, step: Optional[int] = None):
    """Restore checkpoint ``step`` (default the latest) into the structure
    of ``tree_like``: each leaf a tensor of its stored dtype on the device
    of ``tree_like``'s leaf. Returns (tree, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    leaves_like = tree_mod.leaves(tree_like)
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(f"the checkpoint has {len(manifest['leaves'])} leaves, the "
                         f"tree {len(leaves_like)}")
    loaded = [
        _from_numpy(np.load(os.path.join(path, f"leaf_{i:05d}.npy")), entry["dtype"], like)
        for i, (entry, like) in enumerate(zip(manifest["leaves"], leaves_like))
    ]
    return tree_mod.unflatten_like(tree_like, loaded), manifest


def gc_old(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Non-blocking save: snapshot to host, then write in the background.
    ``wait()`` joins the write in flight and raises what it raised (call
    before shutdown; ``save`` calls it first)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, meta: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = tree_mod.map(lambda t: _whole(t).detach().to("cpu", copy=True), tree)
        if not _writer():
            return

        def _write():
            try:
                self.last_path = save(self.directory, step, host_tree, meta)
                gc_old(self.directory, self.keep)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
