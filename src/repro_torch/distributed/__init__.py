"""Single-device step builders.  Sharding rules, the pipeline and the
prefill/decode steps come with ROADMAP Q1.2 and Q1.4."""
from .steps import make_train_step
