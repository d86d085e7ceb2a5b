"""Tunable operator presets, enumerated from the port's declarative registry.

The port's own copy of ``repro.configs.tuna_ops``: every registered
``OpDef`` preset of ``repro_torch.core.op_registry`` becomes a named
``OPERATORS`` entry (``name -> factory(target_kind)``), so the tuning
matrix, the fleet job grid and the CLI widen with the registry."""
from typing import Callable, Dict

from repro_torch.core import op_registry
from repro_torch.core.op_registry import Space


def _factory(family: str, preset: op_registry.Preset,
             ) -> Callable[..., Space]:
    def make(kind: str = preset.kind) -> Space:
        return op_registry.make_space(family, preset.attrs, kind)
    make.__name__ = f"make_{family}"
    return make


# name -> factory(target_kind), in registry order: the paper set first
# (matmul/conv/depthwise/bmm), then the model-zoo families the port has
OPERATORS: Dict[str, Callable[..., Space]] = {
    name: _factory(family, preset)
    for name, (family, preset) in op_registry.all_presets().items()
}

# small fixed subset exercised by `python -m repro_torch.tuna tune --smoke`
# (one matmul + one batched space, seconds to tune)
SMOKE_OPERATORS = ("dense_256", "batch_matmul")

# one preset per model-zoo family (a zoo smoke tunes these on every target)
ZOO_OPERATORS = ("moe_dispatch", "ssm_scan", "mlstm_chunk", "flash_gqa")
