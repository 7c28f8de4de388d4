"""Step builders, sharding rules and the GPipe pipeline.

``steps`` builds the single-device train, prefill and decode steps and
assembles them with their abstract inputs and shardings
(``build_jitted``); ``sharding`` and ``params`` hold the mesh, partition
specs and sharding rules; ``pipeline`` runs the paper's GPipe schedule
with AdaTopK on the pod-crossing edge.  ``make_train_step`` is loaded on
first use, so the model code can import ``sharding`` without loading the
steps, which import the models."""


def __getattr__(name):
    if name == "make_train_step":
        from .steps import make_train_step
        return make_train_step
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
