"""Models on the training path: the dense decoder block and its OP-DAG."""
from . import attention, causal_lm, layers, opgraph_models
