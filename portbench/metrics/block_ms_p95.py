"""block_ms_p95: the 95th percentile of the time of every block in the
window (a block: K rounds of every realization, from the call of
``run_block`` until its state is on the host), in milliseconds."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.block_s, 95))
