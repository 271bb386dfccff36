"""round_loop.step_host_us: the mean host time of one round's enqueue (the
program's span ``round/step``) in the span stretch, under the profiler,
in microseconds."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.mean_us(ctx, "round/step")
