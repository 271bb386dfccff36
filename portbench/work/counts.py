"""Work counts of the kernels' contracts and of the model step, from the
shapes and the rows a round needs, and the chip's peaks.

The counts are what the algorithm needs on these inputs, not what an
implementation does: only the rows whose mask is non-zero (the returned
clients' processed points and the parity rows) count, each read once, and
the summed (q, c) gradient is written once.  A 3xTF32 kernel does three
products for each one counted here, and a kernel that also computes the
clients that did not return does work counted nowhere.
"""
from __future__ import annotations

import json
from pathlib import Path

F32 = 4
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def linreg_grad_masked(q: int, c: int, rows: int) -> tuple[int, int]:
    """(operations, bytes) of sum_rows w x^T (x theta - y) over `rows`
    embedded rows: x theta and x^T r are 2 q c each a row; a row reads x
    (q), y (c) and its mask entry; theta is read and g written once."""
    flops = 4 * q * c * rows
    nbytes = F32 * (rows * (q + c + 1) + 2 * q * c)
    return flops, nbytes


def rff_linreg_grad_masked(d: int, q: int, c: int, client_rows: int,
                           parity_rows: int) -> tuple[int, int]:
    """(operations, bytes) of the fused round: each client row is embedded
    (X Omega, 2 d q) before its gradient (4 q c); a parity row is already
    embedded.  A client row reads x (d), y (c) and its mask entry, a
    parity row phi (q), y and its mask entry; Omega, delta and theta are
    read and g written once."""
    flops = client_rows * (2 * d * q + 4 * q * c) + parity_rows * 4 * q * c
    nbytes = F32 * (client_rows * (d + c + 1) + parity_rows * (q + c + 1)
                    + d * q + q + 2 * q * c)
    return flops, nbytes


def step_flops(q: int, c: int, rows: int) -> int:
    """Model operations of one round of one realization: the gradient over
    the rows it needs (4 q c a row) and the update theta - lr (g / m +
    l2 theta) (5 q c).  The feature map is not counted: the paper computes
    it once a point, at set-up."""
    return 4 * q * c * rows + 5 * q * c


def least_seconds(flops: int, nbytes: int) -> tuple[float, str]:
    """The least time the card could take and which bound sets it."""
    t_ops = flops / PEAKS["tf32_flops_per_s"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
