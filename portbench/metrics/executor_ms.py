"""Milliseconds a step in ``DecentralizedRuntime.train_step`` (the RAD
forward and backward over the stages, the wire codec on each compressed
edge): the mean of a host span a step that ends when the device has
finished, in the traced window."""
UNIT = "ms"
LAYER = "OP-DAG executor"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(ctx):
    spans = ctx.spans.get("executor") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
