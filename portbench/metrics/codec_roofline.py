"""The wire codec's share of its bandwidth roofline: the bytes its
launches must move (frozen count: each input byte read once, each output
byte written once, at the shapes and k of the planned edges) at the
card's 3.35 TB/s, over the device seconds of its kernels
(``encode_kernel``, ``decode_kernel``) in the traced window."""
from portbench.harness.yardstick import PEAK_HBM_BYTES, step_codec_bytes

UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.codec_edges or not ctx.steps:
        return None
    seconds = (ctx.trace.kernel_s("encode_kernel")
               + ctx.trace.kernel_s("decode_kernel"))
    if seconds <= 0:
        return None
    nbytes = step_codec_bytes(ctx.codec_edges) * ctx.steps
    return 100.0 * nbytes / PEAK_HBM_BYTES / seconds
