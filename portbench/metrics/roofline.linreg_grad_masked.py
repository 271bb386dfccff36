"""roofline.linreg_grad_masked: the share of its roofline that kernel 3
reaches over the profiled stretch: the least time of the work its contract
needs on these inputs (``work/counts.linreg_grad_masked``, a call a
realization-round) over its device time.  Nothing where the stretch has no
device time for it or its launches are not one a realization-round."""
from portbench.work import counts

KERNEL = "linreg_grad_masked"


def read(ctx):
    st = ctx.stretch
    if st is None or KERNEL not in st["kernel_s"]:
        return None
    rows = [int(r) for blk in ctx.stretch_rows for r in blk.ravel()]
    if st["launches"][KERNEL] != len(rows):
        return None
    q, c = ctx.cfg["q"], ctx.cfg["c"]
    least = sum(counts.least_seconds(*counts.linreg_grad_masked(q, c, r))[0]
                for r in rows)
    return 100.0 * least / st["kernel_s"][KERNEL]
