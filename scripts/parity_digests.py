#!/usr/bin/env python3
"""sha256 digests and times of the port's parity encode kernels.

    python3 scripts/parity_digests.py --src SRC     # needs CUDA

Imports ``repro_torch`` from SRC (the ``src`` directory of a checkout), runs
``parity_encode_batched`` and ``parity_encode`` (client 0) on seeded inputs
at the main path's feature shape (30, 2400, 400) x (30, 400, 2000), its
label shape (q = 10) and a ragged shape whose l and q are not multiples of
4 (the 4-byte copies), and prints one JSON object: the sha256 of each
output's bytes, and the batched encode's ms per call at the feature shape
(CUDA events, 20 calls after a warm-up).  Two trees give the same bits
where their digests agree; run them in one call on one card, in turns
(parent, change, change, parent), to compare their times.
"""
import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"features": (30, 2400, 400, 2000), "labels": (30, 2400, 400, 10),
          "ragged": (3, 129, 37, 130)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("parity_digests: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    out = {"src": str(args.src), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]}
    for name, (n, u, l, q) in SHAPES.items():
        g = torch.randn((n, u, l), generator=gen, device=dev)
        w = 0.2 + torch.rand((n, l), generator=gen, device=dev)
        x = torch.randn((n, l, q), generator=gen, device=dev)
        out[name] = {"shape": [n, u, l, q],
                     "batched": digest(ops.parity_encode_batched(g, w, x)),
                     "single": digest(ops.parity_encode(g[0], w[0], x[0]))}
        if name == "features":
            ops.parity_encode_batched(g, w, x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                ops.parity_encode_batched(g, w, x)
            end.record()
            end.synchronize()
            out[name]["ms"] = start.elapsed_time(end) / 20
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
