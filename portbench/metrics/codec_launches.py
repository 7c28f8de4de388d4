"""Launches of the wire codec's kernels a step (encode and decode), from
the launch counters of ``repro_torch.kernels.topk_compress`` over the
traced window: an exact count."""
UNIT = "launches/step"
LAYER = "kernels"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(ctx):
    if not ctx.codec_edges or not ctx.steps:
        return None
    return ctx.codec_launches / ctx.steps
