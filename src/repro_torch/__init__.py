"""PyTorch + CUDA port of the FusionLLM reproduction.

Mirrors the layout of the JAX package module for module
(``repro_torch/core/rad.py`` does what ``repro/core/rad.py`` does), with
hand-written Hopper kernels in place of the Pallas ones.  Imports torch and
numpy only.  Entry points run on ``device="cuda"`` unless told otherwise.
"""
