"""Config registry of the LM scaffold — port of ``repro.configs``:
``get_config(name)``, ``cells()`` and one module per arch."""
from repro_torch.configs.archs import ARCHS, LONG_CONTEXT_OK
from repro_torch.configs.base import (ModelConfig, MoEConfig, RunConfig,
                                      SHAPES, ShapeConfig, smoke_variant)

__all__ = ["ARCHS", "LONG_CONTEXT_OK", "ModelConfig", "MoEConfig",
           "RunConfig", "SHAPES", "ShapeConfig", "cells", "get_config",
           "smoke_variant"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells with skip annotations."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and arch.name not in LONG_CONTEXT_OK:
                skip = "pure full-attention arch: long_500k skipped (DESIGN.md §4)"
            if skip is None or include_skipped:
                out.append((arch, shape, skip))
    return out
