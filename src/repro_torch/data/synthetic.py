"""Deterministic synthetic token pipeline (the port's copy of
``repro.data.synthetic``: numpy only, so its batches are bit-equal to the
reference's).

Every (stream, step, position) maps to a token via a splittable counter-based
hash (philox-style mix) — so any worker can materialise any batch slice
without coordination, restarts are bit-exact, and data-parallel shards are
provably disjoint (tests/test_torch_substrate.py). A memmap-backed file source with the
same interface covers the "real corpus" path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    # 64-bit splitmix
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Indexable stream: batch(step) -> {tokens, labels} int32 arrays."""

    def __init__(self, cfg: SyntheticConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rows = self.shard * self.local_batch + np.arange(self.local_batch)
        # unique counter per (seed, step, row, position)
        pos = np.arange(c.seq_len + 1, dtype=np.uint64)
        ctr = (
            np.uint64(c.seed) * np.uint64(0x100000000)
            + np.uint64(step) * np.uint64(c.global_batch * (c.seq_len + 1))
            + rows[:, None].astype(np.uint64) * np.uint64(c.seq_len + 1)
            + pos[None, :]
        )
        toks = (_mix(ctr) % np.uint64(c.vocab)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapTokens:
    """File-backed token stream (.bin of int32), same interface."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 shard: int = 0, num_shards: int = 1):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = global_batch // num_shards
        self.tokens_per_step = global_batch * (seq_len + 1)
        self.n_steps = len(self.data) // self.tokens_per_step

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        step = step % max(1, self.n_steps)
        base = step * self.tokens_per_step + self.shard * self.local_batch * (
            self.seq_len + 1
        )
        flat = np.asarray(
            self.data[base: base + self.local_batch * (self.seq_len + 1)]
        ).reshape(self.local_batch, self.seq_len + 1)
        return {"tokens": flat[:, :-1], "labels": flat[:, 1:]}
