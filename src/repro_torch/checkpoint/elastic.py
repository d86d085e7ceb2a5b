"""Elastic re-meshing: restore a checkpoint onto a different device count
(the port of ``repro.checkpoint.elastic``).

Checkpoints are stored unsharded per leaf (``store.py``), so elasticity is a
matter of computing the placements for the new mesh and cutting each
rank's shards out of the restored leaves. ``reshard_live`` moves a tree of
DTensors between meshes (a graceful shrink on failure without a round trip
through the disk).
"""
from __future__ import annotations

from typing import Optional

from repro_torch import tree as tree_mod
from repro_torch.checkpoint import store
from repro_torch.parallel import sharding as sh


def restore_on_mesh(directory: str, tree_like, new_mesh, kind: str = "params",
                    params_like=None, step: Optional[int] = None):
    """kind: 'params' | 'opt' | 'state' | 'batchlike' ('state': the
    trainer's ``(params, opt_state)`` checkpoint). ``tree_like`` gives the
    structure (its leaves' values are not read; plain, DTensor or meta
    tensors). Returns (tree of DTensors on ``new_mesh``, manifest)."""
    if kind == "params":
        placements = sh.params_sharding(tree_like, new_mesh)
    elif kind == "opt":
        assert params_like is not None
        placements = sh.opt_state_sharding(tree_like, params_like, new_mesh)
    elif kind == "state":
        params, opt_state = tree_like
        placements = (sh.params_sharding(params, new_mesh),
                      sh.opt_state_sharding(opt_state, params, new_mesh))
    else:
        placements = sh.batch_sharding(tree_like, new_mesh)
    import torch

    host = torch.device("cpu")
    like = tree_mod.map(lambda t: torch.empty(0, device=host), tree_like)
    restored, manifest = store.restore(directory, like, step=step)
    return sh.distribute(restored, placements, new_mesh), manifest


def reshard_live(tree, new_placements, new_mesh):
    """Gather every DTensor leaf whole to the host (a collective over its
    old mesh), then place it on ``new_mesh`` with ``new_placements`` (a
    tree of placements, as the ``*_sharding`` functions give)."""
    host = tree_mod.map(lambda t: t.full_tensor().cpu() if hasattr(t, "full_tensor")
                        else t.detach().cpu(), tree)
    return sh.distribute(host, new_placements, new_mesh)
