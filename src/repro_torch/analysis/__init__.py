"""Analytic model FLOPs and roofline terms.  The HLO analysis of the JAX
package comes with ROADMAP Q1.4b."""
from .model_flops import forward_flops, model_flops, six_nd
