"""Architecture configs.  ``load_all()`` imports every per-arch module so the
registry is populated; ``repro_torch.configs.base.get_arch`` is the public
lookup.  Ported so far: gpt2-xl (the training path's model) and the dense
and vlm configs whose blocks the port has; the MoE, hybrid, xLSTM and
enc-dec configs come with ROADMAP Q1.3."""
from .base import (ArchEntry, InputShape, INPUT_SHAPES, ModelCfg, REGISTRY,
                   get_arch, register)

_LOADED = False

ARCH_IDS = ["mistral-nemo-12b", "llama3-8b", "stablelm-12b", "internvl2-2b",
            "granite-3-8b", "gpt2-xl"]

_MODULES = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3-8b": "llama3_8b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-2b": "internvl2_2b",
    "granite-3-8b": "granite_3_8b",
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
