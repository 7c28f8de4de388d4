"""Seconds of the planner's set-up work: the OP-DAG built and profiled,
OP-Fence's schedule over the testbed, and the compression plan (a host
span of the benchmark around those calls)."""
UNIT = "s"
LAYER = "planner"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx.plan_s
