"""Weights made from the seed on the device, in the layout the program's
parameters take, for the program and the reference alike.

Two layouts: ``fusion`` (the OP-DAG's, one entry a node: ``embed``,
``block_i``, ``head``) and ``gspmd`` (the whole model's, the blocks
stacked on a leading axis, so every layer alike).  A block's leaves are
its family's (``portbench/families/<family>.py``).  Every matrix and
table is drawn in one ``torch.randn`` call over all of them, from a
generator on the device seeded with the seed, and scaled in place as the
program's own initialisation scales it: tables and the head by 0.02, a projection by
``1 / sqrt(fan_in)``.  Norm scales are ones and norm biases zeros.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from portbench.harness import manifest

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def norm_specs(prefix, d, cfg) -> List[Spec]:
    out = [(prefix + ("scale",), (d,), "ones", 0.0)]
    if cfg["norm"] == "layernorm":
        out.append((prefix + ("bias",), (d,), "zeros", 0.0))
    return out


def specs(cfg: dict, layout: str, seq: int) -> List[Spec]:
    """(path, shape, kind, scale) of every leaf, in the program's order;
    the blocks' leaves are their family's ``block_specs``."""
    fam = manifest.family(cfg)
    d, L = cfg["d_model"], cfg["n_layers"]
    p = max(cfg["vocab_pad_to"], 1)
    V = (cfg["vocab"] + p - 1) // p * p
    learned = cfg["rope_fraction"] == 0.0
    max_seq = max(cfg["max_seq"], seq)
    if layout == "fusion":
        out = [(("embed", "tok", "table"), (V, d), "normal", 0.02)]
        if learned:
            out.append((("embed", "pos", "table"), (max_seq, d), "normal", 0.02))
        for i in range(L):
            out += [((f"block_{i}",) + path, shape, kind, scale)
                    for path, shape, kind, scale in fam.block_specs(cfg, i)]
        out += norm_specs(("head", "ln"), d, cfg)
        out.append((("head", "w", "w"), (d, V), "normal", 0.02))
        return out
    if layout != "gspmd":
        raise ValueError(f"unknown layout {layout!r}")
    out = [(("embed", "table"), (V, d), "normal", 0.02)]
    out += norm_specs(("final_norm",), d, cfg)
    out.append((("head", "w"), (d, V), "normal", 0.02))
    if learned:
        out.append((("pos_embed", "table"), (max_seq, d), "normal", 0.02))
    first = fam.block_specs(cfg, 0)
    for i in range(1, L):
        if fam.block_specs(cfg, i) != first:
            raise ValueError(
                f"the gspmd layout stacks the blocks, and layer {i} of "
                f"family {cfg['family']!r} differs from layer 0")
    out += [(("blocks",) + path, (L,) + shape, kind, scale)
            for path, shape, kind, scale in first]
    return out


def make(cfg: dict, layout: str, seq: int, seed: int,
         device: torch.device) -> dict:
    """The parameter tree for ``seed``: float32, on ``device``."""
    sp = specs(cfg, layout, seq)
    total = sum(math.prod(s[1]) for s in sp if s[2] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, kind, scale in sp:
        if kind == "normal":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape).mul_(scale)
            off += n
        elif kind == "ones":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def count(cfg: dict, layout: str, seq: int) -> int:
    return sum(math.prod(s[1]) for s in specs(cfg, layout, seq))
