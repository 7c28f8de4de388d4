"""Architecture configuration schema.

One :class:`ModelCfg` describes any architecture in the assigned pool
(dense / MoE / SSM / hybrid / xLSTM / enc-dec / VLM / audio).  Each config
module under ``repro_torch/configs`` exports ``FULL`` (the exact assigned
architecture) and ``SMOKE`` (a reduced same-family variant: ≤2 layers,
d_model ≤ 512, ≤4 experts) plus registers itself in :data:`REGISTRY`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                     # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0               # 0 -> d_model // n_heads
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    rope_fraction: float = 1.0      # 0 -> learned positional embeddings
    rope_theta: float = 10_000.0
    max_seq: int = 8192             # only used for learned pos-emb sizing
    window: Optional[int] = None    # sliding-window attention (train/serve)
    long_window: Optional[int] = 4096  # SWA window substituted for long_500k
    tie_embeddings: bool = False
    qkv_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_impl: str = "ragged"        # ragged | capacity | loop
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25

    # --- SSM / hybrid (Mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0             # hybrid: shared attn after every k SSM blocks
    n_shared_attn: int = 0          # alternating shared attention blocks

    # --- xLSTM ---
    slstm_every: int = 0            # one sLSTM per this many blocks (rest mLSTM)

    # --- enc-dec ---
    n_enc_layers: int = 0           # n_layers counts enc+dec when family=encdec

    # --- multimodal stubs ---
    n_prefix: int = 0               # patch/frame embeddings prepended
    d_frontend: int = 0             # stub frontend embedding width

    # --- numerics ---
    dtype: Any = torch.float32        # activation dtype
    param_dtype: Any = torch.float32
    vocab_pad_to: int = 1           # pad embedding/head vocab dim (sharding)
    remat: bool = False             # checkpoint each block (train memory)
    remat_policy: str = "nothing"   # nothing | dots (save matmul outputs)

    # provenance
    source: str = ""                # paper / model-card citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("moe",) and (self.n_experts == 0 or self.top_k == 0):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")
        if self.family == "hybrid" and self.attn_every == 0:
            raise ValueError(f"{self.name}: hybrid needs attn_every")
        if self.family == "encdec" and self.n_enc_layers == 0:
            raise ValueError(f"{self.name}: encdec needs n_enc_layers")

    @property
    def vocab_padded(self) -> int:
        p = max(self.vocab_pad_to, 1)
        return ((self.vocab + p - 1) // p) * p

    @property
    def n_dec_layers(self) -> int:
        return self.n_layers - self.n_enc_layers if self.family == "encdec" \
            else self.n_layers

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------- shapes --
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: ModelCfg
    smoke: ModelCfg
    # which input shapes apply (DESIGN.md §5 notes the skips)
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k",
                               "long_500k")
    skip_notes: str = ""


def register(entry: ArchEntry) -> ArchEntry:
    REGISTRY[entry.arch_id] = entry
    return entry


def get_arch(arch_id: str) -> ArchEntry:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa
    _c.load_all()
    return REGISTRY[arch_id]
