"""round_loop.readbacks_per_block: the device-to-host reads of a block (the
program's spans ``block/readback``, one a read) over the span stretch's
blocks."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.per_block(ctx, "block/readback")
