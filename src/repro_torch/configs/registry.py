"""Architecture registry: ``--arch <id>`` → config + family + shapes (the
reference's ``configs/registry.py`` over the port's configs)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.configs.shapes import FAMILY_SHAPES

_MODULES = {
    "smollm-135m": "smollm_135m",
    "deepseek-67b": "deepseek_67b",
    "qwen3-0.6b": "qwen3_0_6b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "pna": "pna",
    "equiformer-v2": "equiformer_v2",
    "gin-tu": "gin_tu",
    "egnn": "egnn",
    "deepfm": "deepfm",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke_config: Any
    model_module: str | None = None     # gnn family: module under models.gnn

    @property
    def shape_ids(self) -> tuple[str, ...]:
        return tuple(FAMILY_SHAPES[self.family])


def get_arch(arch_id: str) -> ArchSpec:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY, config=mod.CONFIG,
                    smoke_config=mod.SMOKE,
                    model_module=getattr(mod, "MODEL", None))


def all_cells() -> list[tuple[str, str]]:
    """All 40 (arch × shape) cells, in the reference's order."""
    out = []
    for a in ARCH_IDS:
        spec = get_arch(a)
        out.extend((a, s) for s in spec.shape_ids)
    return out
