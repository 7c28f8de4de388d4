"""Analytic model FLOPs, roofline terms, and the HLO-text collective
parser (which reads the module text the JAX package's dry run saves)."""
from .model_flops import forward_flops, model_flops, six_nd
from .hlo import collective_bytes, parse_hlo_computations, while_trip_counts
from .roofline import RooflineTerms, roofline_terms, HW
