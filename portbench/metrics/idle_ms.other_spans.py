"""idle_ms.other_spans: milliseconds a block of the device's idle time in the
span stretch charged to the program's spans ``block/run``, ``run/init`` and
``run/finish`` outside every span inside them, as
``trace.idle_by_span`` charges it; nothing where the stretch's
kernel records fell short."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.idle_ms(ctx, "other_spans")
