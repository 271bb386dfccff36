"""setup_s: seconds from the process's start to the first timed block:
imports, inputs, the kernels' build or load, the program's set-up and the
warm-up blocks."""


def read(ctx):
    return ctx.setup_s
