"""Per-kernel microbenchmark of the round path (the ``kernels`` artifact
section; the port of ``repro.launch.kernel_bench``).

Times every kernel the federated round path is built from — `rff_embed`,
`linreg_grad_masked`, `parity_encode_batched`, and the fused
embed->gradient `rff_linreg_grad_masked` against its two-pass equivalent
— and returns the ``kernels`` section of the scheme-comparison artifact.
The headline number is ``fused_vs_two_pass_ratio``: the fused kernel's
time over the two-pass (embed, then gradient) time at the same shapes.

``kernel_backend`` keeps the reference's vocabulary:

  * ``"pallas"`` times the kernels: the `repro_torch.kernels.ops`
    wrappers, each call on CUDA tensors one launch of the hand-written
    kernel (counted in ``ops.LAUNCHES``; the two-pass call is one launch
    of `rff_embed` and one of `linreg_grad_masked`).  On the CPU the
    wrappers run their plain versions, and the section says so
    (``interpret`` True);
  * ``"xla"`` times the plain compositions of `repro_torch.kernels.ref`,
    called directly: never a launch.

Each timing is the mean over ``iters`` calls after ``WARMUP`` calls, from
a synchronized device to a synchronized device: kernel time, not the
host's enqueue time.  The inputs come from ``np.random.default_rng(seed)``
in the reference's order (`bench_inputs`), so both packages time the same
numbers, and `kernel_calls` binds the five timed functions so a caller can
compare their outputs.  `validate_kernels` and `compare_kernels` are the
reference's, unchanged.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops, ref

#: kernel names every ``kernels`` section must time
KERNEL_NAMES = ("rff_embed", "linreg_grad_masked", "parity_encode_batched",
                "rff_linreg_grad_fused", "two_pass_embed_grad")

#: default regression threshold: fresh us_per_call may not exceed
#: threshold x committed us_per_call (only slowdowns fail)
DEFAULT_THRESHOLD = 3.0

#: untimed calls before each timed loop
WARMUP = 2

# (n_clients, l, d, q, c, u) per scale; "full" is the paper's §V-A
# operating point (784-dim MNIST, q = 2000)
SCALES = {
    "smoke": dict(n_clients=4, l=64, d=16, q=128, c=4, u=32),
    "default": dict(n_clients=12, l=128, d=64, q=512, c=8, u=128),
    "full": dict(n_clients=30, l=400, d=784, q=2000, c=10, u=1200),
}


def _time(fn, *args, iters: int, device: torch.device,
          warmup: int = WARMUP) -> float:
    """Mean us/call of ``fn(*args)`` after ``warmup`` calls, the timed loop
    between two device synchronizations."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e6


def bench_inputs(n_clients: int, l: int, d: int, q: int, c: int, u: int,
                 seed: int = 0, device=None) -> dict:
    """The benchmark's inputs as float32 tensors on `device`, drawn from
    ``np.random.default_rng(seed)`` in the reference's order: x_raw (n, l,
    d), omega (d, q), delta (q,), theta (q, c), y (n, l, c), an 80% random
    mask (n, l), generators g (n, u, l) and weights w (n, l)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    draws = {
        "x_raw": rng.normal(size=(n_clients, l, d)),
        "omega": rng.normal(size=(d, q)) / 5.0,
        "delta": rng.uniform(0, 2 * np.pi, size=(q,)),
        "theta": rng.normal(size=(q, c)) * 0.1,
        "y": rng.normal(size=(n_clients, l, c)),
        "mask": rng.uniform(size=(n_clients, l)) < 0.8,
        "g": rng.normal(size=(n_clients, u, l)),
        "w": rng.uniform(0.5, 1.0, size=(n_clients, l)),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in draws.items()}


def kernel_calls(inputs: dict, kernel_backend: str = "pallas",
                 phi=None) -> dict:
    """{name: (fn, args)} of the five timed functions over `inputs`.

    The gradient and parity calls take the embedded (n, l, q) tensor
    `phi`; it defaults to the backend's own embedding of ``x_raw``, as the
    reference's benchmark computes it."""
    if kernel_backend not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}")
    k = ops if kernel_backend == "pallas" else ref
    x_raw, omega, delta = inputs["x_raw"], inputs["omega"], inputs["delta"]
    y, mask = inputs["y"], inputs["mask"]
    n, l, d = x_raw.shape
    q = omega.shape[1]

    def embed(x2d):
        return k.rff_embed(x2d, omega, delta)

    def grad(p, th, yy, mm):
        return k.linreg_grad_masked(p, th, yy, mm)

    def parity(gg, ww, pp):
        return k.parity_encode_batched(gg, ww, pp)

    if kernel_backend == "pallas":
        prep = (ops.prepare_rff_operands(x_raw, omega) if omega.is_cuda
                else None)

        def fused(x, th):
            return ops.rff_linreg_grad_masked(x, omega, delta, th, y, mask,
                                              prepared=prep)
    else:
        def fused(x, th):
            return ref.rff_linreg_grad_masked(x, omega, delta, th, y, mask,
                                              n_real=n)

    def two_pass(x, th):
        return grad(embed(x.reshape(n * l, d)).reshape(n, l, q), th, y,
                    mask)

    x2d = x_raw.reshape(n * l, d)
    if phi is None:
        phi = embed(x2d).reshape(n, l, q)
    th = inputs["theta"]
    return {
        "rff_embed": (embed, (x2d,)),
        "linreg_grad_masked": (grad, (phi, th, y, mask)),
        "parity_encode_batched": (parity, (inputs["g"], inputs["w"], phi)),
        "rff_linreg_grad_fused": (fused, (x_raw, th)),
        "two_pass_embed_grad": (two_pass, (x_raw, th)),
    }


def run_kernel_bench(n_clients: int = 12, l: int = 128, d: int = 64,
                     q: int = 512, c: int = 8, u: int = 128,
                     iters: int = 10, seed: int = 0,
                     kernel_backend: str = "xla", device=None) -> dict:
    """Time the round path's kernels at one shape on `device` (default
    the GPU); return the section dict.

    Shapes mirror the runtime's layouts: embedding flattens the client
    axis into (n*l, d) rows; the gradient/parity kernels run over the
    dense (n, l, ·) client tensor.  The fused and two-pass timings share
    identical inputs, so their ratio isolates the fusion itself.
    """
    if kernel_backend not in ("xla", "pallas"):
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}")
    dev = resolve_device(device)
    inputs = bench_inputs(n_clients, l, d, q, c, u, seed=seed, device=dev)
    calls = kernel_calls(inputs, kernel_backend)
    entries = {name: _time(fn, *args, iters=iters, device=dev)
               for name, (fn, args) in calls.items()}
    return {
        "backend": kernel_backend,
        # True where the wrappers ran their plain versions (not the card)
        "interpret": kernel_backend == "pallas" and dev.type != "cuda",
        "device": str(dev),
        "iters": int(iters),
        "shapes": {"n_clients": n_clients, "l": l, "d": d, "q": q, "c": c,
                   "u": u},
        "entries": {k: {"us_per_call": float(v)}
                    for k, v in entries.items()},
        "fused_vs_two_pass_ratio": float(
            entries["rff_linreg_grad_fused"]
            / entries["two_pass_embed_grad"]),
    }


def validate_kernels(section) -> list[str]:
    """Problems with a ``kernels`` artifact section (empty == valid)."""
    errs = []
    if not isinstance(section, dict):
        return [f"kernels: must be an object, got {type(section).__name__}"]
    if section.get("backend") not in ("xla", "pallas"):
        errs.append(f"kernels/backend: bad value {section.get('backend')!r}")
    entries = section.get("entries")
    if not isinstance(entries, dict):
        return errs + ["kernels/entries: missing"]
    for name in KERNEL_NAMES:
        entry = entries.get(name)
        us = entry.get("us_per_call") if isinstance(entry, dict) else None
        if not _is_pos(us):
            errs.append(f"kernels/entries/{name}/us_per_call: "
                        f"bad value {us!r}")
    ratio = section.get("fused_vs_two_pass_ratio")
    if not _is_pos(ratio):
        errs.append(f"kernels/fused_vs_two_pass_ratio: bad value {ratio!r}")
    shapes = section.get("shapes")
    if not isinstance(shapes, dict) or not all(
            isinstance(shapes.get(k), int) and shapes.get(k) > 0
            for k in ("n_clients", "l", "d", "q", "c", "u")):
        errs.append(f"kernels/shapes: bad value {shapes!r}")
    return errs


def compare_kernels(fresh: dict, committed: dict,
                    threshold: float = DEFAULT_THRESHOLD) -> list[str]:
    """Regression gate: fresh timings vs a committed ``kernels`` section.

    Returns a problem string per kernel whose fresh us_per_call exceeds
    ``threshold`` x the committed one (one-sided: speedups always pass),
    plus one if the fused-vs-two-pass ratio regressed past the same
    factor.  Both sections must validate first; structural problems are
    reported instead of timings nonsense.
    """
    errs = [f"fresh artifact: {e}" for e in validate_kernels(fresh)]
    errs += [f"committed artifact: {e}" for e in validate_kernels(committed)]
    if errs:
        return errs
    if threshold <= 1.0:
        return [f"threshold must exceed 1.0, got {threshold}"]
    for name in KERNEL_NAMES:
        new = fresh["entries"][name]["us_per_call"]
        old = committed["entries"][name]["us_per_call"]
        if new > threshold * old:
            errs.append(
                f"{name}: {new:.1f} us/call vs committed {old:.1f} "
                f"(> {threshold:.2f}x regression threshold)")
    new_r = fresh["fused_vs_two_pass_ratio"]
    old_r = committed["fused_vs_two_pass_ratio"]
    if new_r > threshold * old_r:
        errs.append(
            f"fused_vs_two_pass_ratio: {new_r:.3f} vs committed "
            f"{old_r:.3f} (> {threshold:.2f}x regression threshold)")
    return errs


def _is_pos(val) -> bool:
    return isinstance(val, (int, float)) and np.isfinite(val) and val > 0
