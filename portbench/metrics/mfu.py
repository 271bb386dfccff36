"""mfu: the model's operations over the window (``work/counts.step_flops``
of every realization-round, the rows it needed) over the window's seconds
times the card's float32 peak (TF32, ``work/peaks.json``), in percent."""
from portbench.work import counts


def read(ctx):
    q, c = ctx.cfg["q"], ctx.cfg["c"]
    flops = sum(counts.step_flops(q, c, int(r))
                for blk in ctx.window_rows for r in blk.ravel())
    return 100.0 * flops / (ctx.window_s * ctx.peaks["tf32_flops_per_s"])
