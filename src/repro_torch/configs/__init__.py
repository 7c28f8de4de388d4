"""Architecture configs.  ``load_all()`` imports every per-arch module so the
registry is populated; ``repro_torch.configs.base.get_arch`` is the public
lookup."""
from .base import (ArchEntry, InputShape, INPUT_SHAPES, ModelCfg, REGISTRY,
                   get_arch, register)

_LOADED = False

ARCH_IDS = [
    "zamba2-7b", "deepseek-moe-16b", "mistral-nemo-12b", "llama3-8b",
    "mixtral-8x7b", "stablelm-12b", "internvl2-2b", "seamless-m4t-large-v2",
    "granite-3-8b", "xlstm-1_3b", "gpt2-xl",
]

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3-8b": "llama3_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-2b": "internvl2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "granite-3-8b": "granite_3_8b",
    "xlstm-1_3b": "xlstm_1_3b",
    "gpt2-xl": "gpt2_xl",
}

# accepted aliases (the assignment writes xlstm-1.3b)
ALIASES = {"xlstm-1.3b": "xlstm-1_3b"}


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
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
