"""Step builders, sharding rules and the GPipe pipeline.

``steps`` builds the single-device train, prefill and decode steps and
assembles them with their abstract inputs and shardings
(``build_jitted``); ``sharding`` and ``params`` hold the mesh, partition
specs and sharding rules; ``pipeline`` runs the paper's GPipe schedule
with AdaTopK on the pod-crossing edge."""
from .steps import make_train_step
