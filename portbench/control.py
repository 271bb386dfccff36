"""The control of a cell's check: the plain reference one precision below
the configuration's put in the program's place (the control of the
configuration's program module, for CodedFedL the reference in TF32), on
several seeds in one process.  It has to come out not correct on every
seed; the smallest reading of each number is the upper reading its limit
is set below.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    failed_all = True
    for seed in args.seeds:
        correct, checks = harness.control(bench, args.workload, seed)
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": checks}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
