"""Share of the engine's slot-steps spent on free slots (the scheduler,
``launch/engine.py``): wasted / (live + wasted), from its counters over
the whole window."""


def read(r):
    e = r.counters.get("engine")
    if not e or not e["slot_steps"] + e["wasted_slot_steps"]:
        return None
    return 100.0 * e["wasted_slot_steps"] / (e["slot_steps"] + e["wasted_slot_steps"])
