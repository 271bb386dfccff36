"""rounds_per_s: every round of every realization completed in the window,
over the window's seconds on the host clock."""


def read(ctx):
    return ctx.window_rounds / ctx.window_s
