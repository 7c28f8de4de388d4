"""Analytic model FLOPs.  The HLO and roofline analyses of the JAX package
come with ROADMAP Q1.4."""
from .model_flops import forward_flops, model_flops, six_nd
