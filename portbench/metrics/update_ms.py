"""Milliseconds a step in AdamW's update (computed in the gradients'
memory): the mean of a host span a step that ends when the device has
finished, in the traced window."""
UNIT = "ms"
LAYER = "optimizer"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(ctx):
    spans = ctx.spans.get("update") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
