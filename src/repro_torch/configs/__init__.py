"""Architecture configs.  ``load_all()`` imports every per-arch module so the
registry is populated; ``repro_torch.configs.base.get_arch`` is the public
lookup.  Only gpt2-xl, the training path's model, is ported so far."""
from .base import (ArchEntry, InputShape, INPUT_SHAPES, ModelCfg, REGISTRY,
                   get_arch, register)

_LOADED = False

ARCH_IDS = ["gpt2-xl"]

_MODULES = {
    "gpt2-xl": "gpt2_xl",
}


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _MODULES.values():
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def resolve(arch_id: str) -> ArchEntry:
    load_all()
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
