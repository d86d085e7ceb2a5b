"""The benchmark harness of ``repro_torch``: run a cell, read its metrics."""
