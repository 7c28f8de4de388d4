"""The whole step's share of the card's float32 peak: the frozen FLOP
count of the steps completed in the traced window over the window's
seconds, against 67 TFLOP/s."""
from portbench.harness.yardstick import PEAK_FP32_FLOPS

UNIT = "%"
LAYER = "whole step"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    return (100.0 * ctx.flops_per_step * ctx.steps / ctx.trace.window_s
            / PEAK_FP32_FLOPS)
