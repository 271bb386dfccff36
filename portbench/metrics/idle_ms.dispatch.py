"""idle_ms.dispatch: milliseconds a block of the device's idle time in the
span stretch charged to the rounds' enqueue (the program's span
``round/step``) and to the block span's own time outside it
(``scan/compile``, ``scan/execute``), as ``trace.idle_by_span``
charges it; nothing where the stretch's kernel records fell short."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.idle_ms(ctx, "dispatch")
