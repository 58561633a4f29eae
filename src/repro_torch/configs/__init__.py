"""Config registry of the archs the port serves.

`get_config(name)` returns the full published config; `get_config(name,
reduced=True)` the CPU test derivative.
"""

from __future__ import annotations

from repro_torch.configs import qwen3_0_6b
from repro_torch.configs.base import ModelConfig

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (qwen3_0_6b,)}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    try:
        cfg = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"the port serves {ARCH_NAMES}, not {name!r}") from None
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
