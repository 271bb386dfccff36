"""round_loop.uploads_per_block: the host-to-device copies of a block (the
program's spans ``block/upload``, one a copy) over the span stretch's
blocks."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.per_block(ctx, "block/upload")
