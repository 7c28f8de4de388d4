"""Share of the traced window in which no operation ran on the card."""
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
