"""idle_ms.upload: milliseconds a block of the device's idle time in the span
stretch charged to the host-to-device copies (the program's span
``block/upload``), as ``trace.idle_by_span`` charges it; nothing
where the stretch's kernel records fell short."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.idle_ms(ctx, "upload")
