"""idle_ms.caller: milliseconds a block of the device's idle time in the span
stretch under no program span: the caller's code between blocks, as
``trace.idle_by_span`` charges it; nothing where the stretch's
kernel records fell short."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.idle_ms(ctx, "caller")
