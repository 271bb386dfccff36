"""round_loop.block_ms_p95: the 95th percentile of the time of every block
in the window, as ``block_ms_p95`` reads it, in a cell where that tail is
too unsteady between processes to be an end-to-end metric with a bound,
in milliseconds."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.block_s, 95))
