"""Zero-overhead-when-disabled span timers with a thread-safe collector.

The port of ``repro.obs.spans``.  The runtime's hot paths are annotated
with ``with span("solver/two_step")`` blocks; when the module flag is off
(the default) ``__enter__`` is a single flag check: no clock read, no
device sync, no lock, no profiler range.  `enable()` turns every span in
the process into a wall-clock measurement recorded in one in-process
collector keyed by span name; `totals()` snapshots it.  This collector is
the port's own: it is independent of the reference's ``repro.obs.spans``
flag and records.

Inside a ``torch.profiler`` session a measuring span also opens
``torch.profiler.record_function(name)`` for its duration, so each span is
a ``user_annotation`` event on the clock of the device records, nested in
its parent by time: an idle stretch of the card can be charged to the span
under way at that moment.  Outside a session a measuring span opens no
range (one check of the profiler's state), since a range there records
nothing and costs more than the span's own clock.

A span given ``sync=device`` calls ``torch.cuda.synchronize(device)``
before its clock stops when it measures and the device is a GPU, so the
time covers the work the span enqueued on the card (the counterpart of the
reference's ``jax.block_until_ready``).  The spans that sync wrap whole
setup phases or whole blocks, never one round.

Span names in the runtime:

  ==========================  ==============================================
  ``setup/experiment``        whole scheme setup (`Experiment.__init__`)
  ``solver/two_step``         two-step load-allocation solve
  ``encode/parity``           batched parity encode
  ``trace/generate``          channel-trace block generation
  ``scan/compile``            the first block the experiment's cached
                              step runs (the reference: the first, compiling
                              call of its cached ``lax.scan``)
  ``scan/execute``            every later block of that step (the
                              reference: the warm calls of the scan)
  ``checkpoint/save``         `save_state` (atomic npz write)
  ``checkpoint/restore``      `restore_state` (load + digest verify)
  ``journal/append``          run-journal block append
  ``run/init``                `Experiment.init_state`
  ``run/finish``              `Experiment.finish`
  ``block/run``               one whole `Experiment.run_block`
  ``block/draw``              a block's host delay draw (and its fault
                              rows' draw where faults are on)
  ``block/upload``            one host-to-device copy of a block input
                              (the delays, the learning rates, the carry's
                              lr scale a realization): its count is the
                              block's uploads
  ``round/step``              the host's enqueue of one round of one
                              realization (inside ``scan/*``)
  ``block/readback``          one device-to-host read of a block's
                              results: its count is the block's readbacks
  ``service/block``           one `ExperimentService` block advance
  ``service/ckpt_save``       the service's view of one checkpoint save
  ``service/backoff``         retry backoff sleeps
  ==========================  ==============================================

The port has no compiled scan: its block is a Python loop of eager rounds,
so ``scan/compile`` holds the first block's one-time costs (lazily loaded
CUDA modules, the kernels' first launches) and ``scan/execute`` the warm
blocks.  The names are the reference's, so the same `REQUIRED_SPANS` and
report read both packages.  The ``run/``, ``block/`` and ``round/`` spans
are the port's own and never sync: they time host work, and their ranges
place it on the device trace.

Timing never touches a random stream or a value that flows into a
trajectory: runs with spans enabled are bit-identical to runs with spans
disabled (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time

import torch

__all__ = ["span", "spanned", "enable", "disable", "enabled", "reset",
           "record", "totals", "write_json", "collecting", "SPANS_NAME"]

#: filename `write_json` conventionally uses inside a run directory
SPANS_NAME = "spans.json"

_enabled = False
_lock = threading.Lock()
#: name -> [count, total_s, min_s, max_s]
_records: "dict[str, list]" = {}


def enabled() -> bool:
    """Whether spans currently measure (module-global, process-wide)."""
    return _enabled


def enable() -> None:
    """Turn every `span` in the process into a recorded measurement."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Return spans to their zero-overhead pass-through behavior."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all collected records (the enable flag is left as is)."""
    with _lock:
        _records.clear()


def record(name: str, seconds: float) -> None:
    """Fold one measured duration into the collector (thread-safe)."""
    with _lock:
        rec = _records.get(name)
        if rec is None:
            _records[name] = [1, seconds, seconds, seconds]
        else:
            rec[0] += 1
            rec[1] += seconds
            if seconds < rec[2]:
                rec[2] = seconds
            if seconds > rec[3]:
                rec[3] = seconds


def totals() -> dict:
    """Snapshot the collector: {name: {count, total_s, min_s, max_s}},
    names sorted so the snapshot serializes deterministically."""
    with _lock:
        return {name: {"count": int(rec[0]), "total_s": float(rec[1]),
                       "min_s": float(rec[2]), "max_s": float(rec[3])}
                for name, rec in sorted(_records.items())}


def write_json(path: str) -> str:
    """Write `totals()` as pretty JSON (a run dir's ``spans.json``)."""
    with open(path, "w") as fh:
        json.dump(totals(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


class span:
    """``with span("solver/two_step"): ...`` — wall-clock one region.

    When the module flag is off the context manager is inert (no clock
    read, no sync, no profiler range).  ``force=True`` measures regardless
    of the flag — the duration lands in ``self.elapsed_s`` for the caller,
    but is only folded into the global collector when the flag is on (the
    `ExperimentService` uses this for its always-on per-run health
    timings).  With the flag on, inside a profiler session, the span opens
    a ``record_function`` range.  ``sync`` (a device) makes a measuring
    span wait for that GPU's queued work before its clock stops; the range
    closes after the wait.
    """
    __slots__ = ("name", "elapsed_s", "_t0", "_force", "_sync", "_range")

    def __init__(self, name: str, *, force: bool = False, sync=None):
        self.name = name
        self.elapsed_s = None
        self._t0 = None
        self._force = force
        self._sync = sync
        self._range = None

    def __enter__(self) -> "span":
        if _enabled:
            if torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            self._t0 = time.perf_counter()
        elif self._force:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._t0 is not None:
            if self._sync is not None and \
                    torch.device(self._sync).type == "cuda":
                torch.cuda.synchronize(self._sync)
            self.elapsed_s = time.perf_counter() - self._t0
            self._t0 = None
            if _enabled:
                record(self.name, self.elapsed_s)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def collecting(fresh: bool = True):
    """Enable spans for the duration of the block, restoring the previous
    flag afterwards; ``fresh`` clears the collector first.  Yields the
    module so ``with collecting() as spans: ... spans.totals()`` reads
    naturally."""
    global _enabled
    prev = _enabled
    if fresh:
        reset()
    _enabled = True
    try:
        yield __import__(__name__, fromlist=["totals"])
    finally:
        _enabled = prev
