"""The benchmark of the CodedFedL port (``repro_torch``) on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(with ``--trace 1`` also ``busy_s``, ``window_s`` and a ``breakdown``) and
last ``checks``: each number compared with the plain reference beside its
limit, which also end standard error.  It exits non-zero and prints no
result where there is no card, or fewer than the cell asks for, where the
program is missing, or where a module of JAX or of the JAX package
(``repro``) is loaded once the window has closed.  The program builds its
kernels at a checkout's first run into ``build/repro_torch/`` inside it;
later runs load them from there.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's cores may be shared, and
    # nothing on the host side of a run needs a thread pool
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        out = harness.run(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except (harness.NoChip, ImportError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    # the window has closed: this process must not hold JAX or the JAX
    # package, whatever loaded them
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
