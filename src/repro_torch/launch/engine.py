"""Continuous-batching serve engine: a slot state machine.

Every slot carries its own position (``Model.decode_step`` takes a ``[B]``
pos vector, so rows at different depths share one decode step); an
admission queue (earliest deadline first, FIFO among equal deadlines)
refills a slot the moment it frees (EOS, ``max_new`` or deadline). Prefill
runs on a batch of one at the prompt's own length, and its cache is copied
in place into the live cache at the free slot index. Free slots keep
decoding (the batch shape is fixed) but are masked out of every report:
``wasted_slot_steps`` counts exactly those slot-steps.

Per-request measurement: TTFT (submit -> first token) and end-to-end
latency, aggregated to p50/p95/p99 by ``latency_summary``.

``refresh`` (nullary, True on change) is the schedule-snapshot hot-reload
hook, polled at admission boundaries after the first admission (the
snapshot in force at the first batch was just installed);
``cache_reloads`` counts the swaps it reports.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    eos_id: Optional[int] = None      # finish early when emitted
    deadline_s: Optional[float] = None  # wall budget from submission
    # measurement (filled by the engines; relative to serve() start)
    t_submit: float = 0.0
    t_first: Optional[float] = None   # TTFT instant
    t_done: Optional[float] = None
    truncated: bool = False           # deadline fired before max_new/EOS

    def wants_more(self) -> bool:
        return len(self.out) < self.max_new and not self.truncated and (
            self.eos_id is None or self.eos_id not in self.out)


def latency_summary(values: List[float]) -> Dict[str, float]:
    """p50/p95/p99 (+ mean) over per-request seconds."""
    if not values:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def request_stats(requests: List[Request]) -> Dict:
    """Per-request rows + aggregated TTFT / e2e latency percentiles."""
    rows, ttfts, lats = [], [], []
    for r in requests:
        ttft = None if r.t_first is None else r.t_first - r.t_submit
        lat = None if r.t_done is None else r.t_done - r.t_submit
        if ttft is not None:
            ttfts.append(ttft)
        if lat is not None:
            lats.append(lat)
        rows.append({"rid": r.rid, "prompt_len": len(r.prompt),
                     "max_new": r.max_new, "tokens": len(r.out),
                     "ttft_s": ttft, "latency_s": lat,
                     "truncated": r.truncated})
    return {"requests": rows, "ttft_s": latency_summary(ttfts),
            "latency_s": latency_summary(lats)}


def greedy_decode_reference(model, params, prompt: List[int], max_new: int,
                            cap: int, eos_id: Optional[int] = None) -> List[int]:
    """One-request-at-a-time greedy decode (scalar-pos path) — the oracle
    the schedulers must match token for token."""
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                    device=model.device)}
    cache, pos, last_logits = model.prefill(params, batch, cap)
    out = [int(torch.argmax(last_logits[0, 0]))]
    for t in range(max_new - 1):
        if eos_id is not None and out[-1] == eos_id:
            break
        logits, cache = model.decode_step(
            params, cache, torch.tensor([out[-1]], dtype=torch.int32), pos + t)
        out.append(int(torch.argmax(logits[0])))
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    return out


class _Slot:
    __slots__ = ("req", "deadline")

    def __init__(self):
        self.req: Optional[Request] = None
        self.deadline: Optional[float] = None  # absolute perf_counter time

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousEngine:
    """Slot state machine over a live decode cache of width ``slots``.

    Invariants:
      * a FREE slot's cache content is garbage — refill overwrites the
        whole slot slice (every cache leaf, along the batch axis) when the
        prefilled cache is copied in, so nothing leaks between tenants;
      * ``pos[i]`` is the write index of slot i's *next* token; free slots
        pin pos=0 and tok=0 (their writes land in a slice that refill
        replaces, and the per-slot mask keeps them out of live rows);
      * a request holds its slot from admission until EOS / ``max_new`` /
        deadline, then the slot frees on the same engine step.
    """

    def __init__(self, model, params, slots: int, cap: int, refresh=None):
        self.model = model
        self.params = params
        self.slots = slots
        self.cap = cap
        self.refresh = refresh
        self.cache = model.init_cache(slots, cap)
        self.pos = np.zeros(slots, np.int32)   # next write index per slot
        self.tok = np.zeros(slots, np.int32)   # last emitted token per slot
        self._slots = [_Slot() for _ in range(slots)]
        # stats
        self.engine_steps = 0        # decode steps
        self.slot_steps = 0          # slot-steps doing live work
        self.wasted_slot_steps = 0   # slot-steps on free slots
        self.prefills = 0
        self.cache_reloads = 0
        self.deadline_truncations = 0
        self._admitted = 0

    # ---------------------------------------------------------------- admit
    def _insert(self, one, slot_i: int) -> None:
        # every leaf is [G, B, ...] (batch on axis 1): copy the prefilled
        # batch-of-one cache into slot i of the live cache in place
        for live_d, one_d in zip(self.cache, one):
            for key, leaf in live_d.items():
                leaf[:, slot_i:slot_i + 1].copy_(one_d[key])

    def _admit(self, slot_i: int, req: Request) -> None:
        prompt = torch.tensor([req.prompt], dtype=torch.int32,
                              device=self.model.device)
        cache_1, pos_1, last_logits = self.model.prefill(
            self.params, {"tokens": prompt}, self.cap)
        self.prefills += 1
        tok0 = int(torch.argmax(last_logits[0, 0]))
        self._insert(cache_1, slot_i)
        slot = self._slots[slot_i]
        slot.req = req
        slot.deadline = (None if req.deadline_s is None
                         else req.t_submit + req.deadline_s)
        self.pos[slot_i] = int(pos_1)
        self.tok[slot_i] = tok0
        req.out.append(tok0)
        req.t_first = time.perf_counter() - self._t0
        self._admitted += 1
        self._maybe_finish(slot_i)

    def _maybe_finish(self, slot_i: int) -> None:
        slot = self._slots[slot_i]
        req = slot.req
        now = time.perf_counter() - self._t0
        if slot.deadline is not None and now >= slot.deadline and req.wants_more():
            req.truncated = True
            self.deadline_truncations += 1
        if not req.wants_more():
            req.t_done = now
            slot.req = None
            slot.deadline = None
            self.pos[slot_i] = 0
            self.tok[slot_i] = 0

    # ----------------------------------------------------------------- run
    def run(self, requests: List[Request]) -> None:
        """Serve ``requests`` to completion. Admission order is earliest
        deadline first (stable for equal/absent deadlines)."""
        self._t0 = time.perf_counter()
        queue = sorted(
            requests,
            key=lambda r: (r.deadline_s if r.deadline_s is not None
                           else float("inf")),
        )
        queue.reverse()  # pop() from the tail = earliest deadline
        while queue or any(not s.free for s in self._slots):
            # refill every free slot; the snapshot poll rides the admission
            # boundary (not the very first batch)
            admitting = queue and any(s.free for s in self._slots)
            if admitting and self.refresh is not None and self._admitted:
                if self.refresh():
                    self.cache_reloads += 1
            for i, s in enumerate(self._slots):
                if s.free and queue:
                    self._admit(i, queue.pop())
            live = [i for i, s in enumerate(self._slots) if not s.free]
            if not live:
                continue
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, torch.tensor(self.tok),
                torch.tensor(self.pos))
            self.engine_steps += 1
            self.slot_steps += len(live)
            self.wasted_slot_steps += self.slots - len(live)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # one host sync
            for i in live:
                req = self._slots[i].req
                req.out.append(int(nxt[i]))
                self.tok[i] = int(nxt[i])
                self.pos[i] += 1
                self._maybe_finish(i)

    def stats(self) -> Dict:
        return {"engine_steps": self.engine_steps,
                "slot_steps": self.slot_steps,
                "wasted_slot_steps": self.wasted_slot_steps,
                "prefills": self.prefills,
                "cache_reloads": self.cache_reloads,
                "deadline_truncations": self.deadline_truncations}
