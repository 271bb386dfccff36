"""solver_s: seconds of the two-step load allocation in set-up (the
program's span ``solver/two_step``), or nothing where the scheme has no
allocation."""


def read(ctx):
    return ctx.spans.get("solver/two_step")
