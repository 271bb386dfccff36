"""roofline.rff_linreg_grad_masked: the share of its roofline that kernel
4 reaches over the profiled stretch: the least time of the work its
contract needs on these inputs (``work/counts.rff_linreg_grad_masked``: the
returned clients' rows embedded, the parity rows already embedded; a call
a realization-round) over its device time.  Nothing where the stretch has
no device time for it or its launches are not one a realization-round."""
from portbench.work import counts

KERNEL = "rff_linreg_grad_masked"


def read(ctx):
    st = ctx.stretch
    if st is None or KERNEL not in st["kernel_s"]:
        return None
    rows = [int(r) for blk in ctx.stretch_rows for r in blk.ravel()]
    if st["launches"][KERNEL] != len(rows):
        return None
    d, q, c, u = ctx.cfg["d"], ctx.cfg["q"], ctx.cfg["c"], ctx.u
    least = sum(counts.least_seconds(*counts.rff_linreg_grad_masked(
        d, q, c, r - u, u))[0] for r in rows)
    return 100.0 * least / st["kernel_s"][KERNEL]
