"""ExperimentService: multiplex many resumable runs over one process.

The port of ``repro.launch.service``.  The block-structured runtime
(`repro_torch.core.fed_runtime.Experiment.run_block` over an explicit
`RunState`) turns a training run into a sequence of resumable steps.  This
module adds the scheduler on top: a service accepts frozen
`ExperimentSpec`s as jobs, round-robins one block per job per `step()`,
and checkpoints every run at its own ``checkpoint_every`` boundary under
``root/<run_id>/``.  Because every block boundary is a durable `RunState`,
killing the process (or the machine) loses at most the in-flight block: a
fresh service pointed at the same root resumes every run from its latest
checkpoint and finishes bit-identically to the uninterrupted service —
theta, loss curve, wall-clock log, and adaptive schedule alike
(``tests/test_torch_service.py``).

    svc = ExperimentService("runs/")                 # on the GPU
    svc.submit(spec_a, xs, ys, iterations=200, run_id="a")
    svc.submit(spec_b, xs, ys, iterations=200, run_id="b")
    results = svc.run_until_complete()     # {"a": FedResult, "b": ...}

Checkpoint layout: ``root/<run_id>/ckpt_<rounds_done>.npz`` — atomic
writes, numeric suffix ordering, spec provenance embedded per file
(`repro_torch.checkpoint.io`, the reference's format).

Self-healing (`repro_torch.faults`): a failed block — an injected
`InjectedCrashError` from the run's `FaultProfile.crash_prob`, or any
organic exception — never advances the run's state; the service retries
it with exponential backoff (``retry_backoff * 2**(attempt-1)`` seconds)
and quarantines the run after ``max_retries`` consecutive failures so
one sick job cannot stall its siblings.  Checkpoint corruption
(``ckpt_corrupt_prob``) damages the just-written file on disk; the
in-memory state is unaffected, but a *restarted* service resumes through
``latest_checkpoint(valid_only=True)`` — the digest-verified fallback to
the newest intact snapshot — and re-computes the lost blocks, finishing
bit-identically to a fault-free-infrastructure control.  The chaos stream
and its draw order are the reference's, so a service of the port crashes
and retries where the reference's does.  `health_report` summarizes all
of it.

The experiments run on the service's ``device`` (the GPU unless the
caller asks for another); a client mesh is refused, as the port's
`unsupported_features` refuses it.  A block's forced ``service/block``
span covers its device work: `run_block` reads the block's per-round
records back to the host, which waits for the card, and the span syncs
the device once more before its clock stops.
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.config import ExperimentSpec
from repro_torch.core.fed_runtime import Experiment
from repro_torch.core.run_state import RunState
from repro_torch.device import resolve_device
from repro_torch.faults.inject import InjectedCrashError, corrupt_checkpoint
from repro_torch.obs import spans as obs_spans
from repro_torch.obs.events import RunJournal

__all__ = ["ExperimentService", "ServiceRun"]


@dataclasses.dataclass
class ServiceRun:
    """One submitted job: its experiment, live state, and destination."""
    run_id: str
    spec: ExperimentSpec
    exp: Experiment
    state: RunState
    ckpt_dir: str
    eval_fn: Optional[Callable] = None
    eval_every: int = 10
    result: object = None
    resumed: bool = False          # True if submit() found a checkpoint
    fallback_resume: bool = False  # resumed past a corrupt latest ckpt
    retries: int = 0               # consecutive failures of the CURRENT block
    total_retries: int = 0         # failures over the run's lifetime
    quarantined: bool = False      # gave up after max_retries failures
    last_error: Optional[str] = None
    journal: object = None         # RunJournal when telemetry is enabled
    # always-on per-run wall-clock accounting (host time, forced spans)
    blocks_run: int = 0            # blocks computed (successful _advance)
    block_seconds: float = 0.0     # wall-clock inside run_block
    ckpt_save_seconds: float = 0.0  # wall-clock inside save_state
    backoff_seconds: float = 0.0   # wall-clock slept in retry backoff

    @property
    def done(self) -> bool:
        return self.result is not None


class ExperimentService:
    """Round-robin block scheduler over many concurrent resumable runs.

    Each `submit` builds (or resumes) one run; each `step` advances the
    next unfinished run by ONE block and checkpoints it, so N concurrent
    runs interleave fairly regardless of their horizons.  The service
    itself holds no state outside `self.runs` and the checkpoint root, so
    it is trivially restartable.

    ``device`` is where every run's experiment lives (default the GPU).
    Retry knobs: ``max_retries`` consecutive block failures quarantine a
    run; ``retry_backoff`` (seconds, default 0 so tests never sleep) is
    the base of the exponential backoff between attempts.  ``fault_seed``
    keys the service-level chaos stream — injected crashes and
    checkpoint corruption draw from ``(fault_seed, crc32(run_id),
    rounds_done, total_retries)``, so every retry of a crashed block
    redraws its fate (no deterministic crash loops) while the sequence
    stays reproducible per seed.
    """

    def __init__(self, root: str, *, device=None, mesh=None,
                 max_retries: int = 3, retry_backoff: float = 0.0,
                 fault_seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "the PyTorch port does not support client-mesh sharding "
                "(mesh) yet")
        if max_retries < 0:
            raise ValueError(f"max_retries={max_retries} must be >= 0")
        if retry_backoff < 0:
            raise ValueError(f"retry_backoff={retry_backoff} must be >= 0")
        self.root = str(root)
        self.device = resolve_device(device)
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.fault_seed = int(fault_seed)
        self.runs: "dict[str, ServiceRun]" = {}
        self._order: "list[str]" = []
        self._cursor = 0
        self.last_health: Optional[dict] = None

    # ------------------------------------------------------------ submission
    def submit(self, spec: "ExperimentSpec | dict", x_stack, y_stack,
               iterations: int, *, run_id: Optional[str] = None,
               n_realizations: Optional[int] = None,
               eval_fn: Optional[Callable] = None, eval_every: int = 10,
               nodes=None, rng=None,
               parity_generators=None) -> ServiceRun:
        """Register a run; auto-resumes from ``root/<run_id>/`` when a
        checkpoint already exists there (validating spec provenance).

        ``run_id`` defaults to ``spec.run_id``, then to ``run<k>``; it
        names the checkpoint directory, so resubmitting the same id
        after a kill is exactly how a run is recovered.  A corrupt or
        truncated latest checkpoint is skipped in favor of the newest
        one that passes digest verification (``fallback_resume`` flags
        that this happened — the lost blocks are simply re-computed).
        ``parity_generators`` (n, u, l) replaces the coded family's
        generator draw (the reference's, via ``repro_torch.carry``).
        """
        from repro_torch.api import build_experiment
        if isinstance(spec, dict):
            spec = ExperimentSpec.from_dict(spec)
        rid = run_id or spec.run_id or f"run{len(self.runs)}"
        if rid in self.runs:
            raise ValueError(f"run_id {rid!r} already submitted")
        if spec.checkpoint_every <= 0:
            raise ValueError(
                f"run {rid!r}: service jobs need spec.checkpoint_every > 0 "
                "(a whole-horizon block would starve the other runs)")
        exp = build_experiment(spec, x_stack, y_stack, nodes=nodes, rng=rng,
                               device=self.device,
                               parity_generators=parity_generators)
        ckpt_dir = os.path.join(self.root, rid)
        state = None
        resumed = False
        latest_any = ckpt_io.latest_checkpoint(ckpt_dir)
        latest = ckpt_io.latest_checkpoint(ckpt_dir, valid_only=True)
        fallback = latest_any is not None and latest != latest_any
        if latest is not None:
            state = exp.restore_state(latest)
            if state.iterations != int(iterations) or (
                    (state.n_realizations or None)
                    != (int(n_realizations) if n_realizations else None)):
                raise ValueError(
                    f"run {rid!r}: checkpoint {latest!r} does not match the "
                    f"submitted horizon ({state.iterations} rounds x "
                    f"{state.n_realizations} realizations vs {iterations} "
                    f"x {n_realizations})")
            resumed = True
        if state is None:
            state = exp.init_state(iterations,
                                   n_realizations=n_realizations,
                                   collect=eval_fn is not None)
        run = ServiceRun(run_id=rid, spec=spec, exp=exp, state=state,
                         ckpt_dir=ckpt_dir, eval_fn=eval_fn,
                         eval_every=eval_every, resumed=resumed,
                         fallback_resume=fallback)
        # with telemetry on, journal single-trajectory runs next to their
        # checkpoints (root/<run_id>/events.jsonl) — trimmed/regrown to
        # the restored state, so a resumed journal is extended in place
        if obs_spans.enabled() and state.mode in ("single", "hier"):
            run.journal = RunJournal(ckpt_dir)
            run.journal.reset_to(state.rounds_done)
            run.journal.sync(exp, state)
        self.runs[rid] = run
        self._order.append(rid)
        if state.done:   # resumed a run that was already finished
            run.result = exp.finish(state, eval_fn)
        return run

    # ------------------------------------------------------------ scheduling
    @property
    def pending(self) -> "list[str]":
        return [rid for rid in self._order
                if not (self.runs[rid].done or self.runs[rid].quarantined)]

    def _chaos_rng(self, run: ServiceRun) -> np.random.Generator:
        """Per-(run, block, attempt) chaos stream — `total_retries` in
        the key means a retried block redraws its crash/corruption fate
        instead of deterministically crashing forever."""
        return np.random.default_rng(
            (self.fault_seed, zlib.crc32(run.run_id.encode()),
             run.state.rounds_done, run.total_retries))

    def _advance(self, run: ServiceRun) -> None:
        """One block of `run`, with injected infrastructure faults: a
        crash fires BEFORE the block computes (SIGKILL-style — no state
        advance, no checkpoint); checkpoint corruption damages the file
        just written (detected by the digest on any later restore)."""
        faults = run.exp.faults
        chaos = (self._chaos_rng(run)
                 if faults is not None and faults.has_service_faults
                 else None)
        if chaos is not None:
            # fixed draw order (crash, then corruption) so toggling one
            # knob never shifts the other's realization
            u_crash, u_ckpt = chaos.random(2)
            if u_crash < faults.crash_prob:
                raise InjectedCrashError(
                    f"run {run.run_id!r}: injected crash at block "
                    f"rounds_done={run.state.rounds_done} "
                    f"(attempt {run.retries + 1})")
        with obs_spans.span("service/block", force=True,
                            sync=self.device) as sp_block:
            run.state = run.exp.run_block(run.state, eval_fn=run.eval_fn,
                                          eval_every=run.eval_every)
        run.blocks_run += 1
        run.block_seconds += sp_block.elapsed_s
        with obs_spans.span("service/ckpt_save", force=True) as sp_save:
            path = run.exp.save_state(
                os.path.join(run.ckpt_dir,
                             f"{ckpt_io.CKPT_PREFIX}"
                             f"{run.state.rounds_done:06d}.npz"),
                run.state)
        run.ckpt_save_seconds += sp_save.elapsed_s
        if chaos is not None and u_ckpt < faults.ckpt_corrupt_prob:
            corrupt_checkpoint(path, kind=faults.ckpt_corrupt_kind,
                               rng=chaos)
        if run.journal is not None:
            run.journal.sync(run.exp, run.state)

    def step(self) -> Optional[str]:
        """Advance the next unfinished run by one block, checkpoint it,
        and finish it if that block completed the run.  A failed block
        is retried with exponential backoff on the run's next turn;
        after ``max_retries`` consecutive failures the run is
        quarantined (its checkpoints stay on disk for a later resume).
        Returns the run_id acted on, or None when nothing is pending."""
        pending = self.pending
        if not pending:
            return None
        rid = pending[self._cursor % len(pending)]
        self._cursor += 1
        run = self.runs[rid]
        if run.retries > 0 and self.retry_backoff > 0:
            with obs_spans.span("service/backoff", force=True) as sp:
                time.sleep(self.retry_backoff * 2 ** (run.retries - 1))
            run.backoff_seconds += sp.elapsed_s
        try:
            self._advance(run)
        except Exception as exc:           # noqa: BLE001 — quarantine path
            run.retries += 1
            run.total_retries += 1
            run.last_error = f"{type(exc).__name__}: {exc}"
            if run.retries > self.max_retries:
                run.quarantined = True
            return rid
        run.retries = 0
        run.last_error = None
        if run.state.done:
            run.result = run.exp.finish(run.state, run.eval_fn)
        return rid

    def run_until_complete(self) -> dict:
        """Drive every submitted run to completion (or quarantine);
        {run_id: result} — a quarantined run's result is None.  The full
        per-run health report lands in ``self.last_health``."""
        while self.step() is not None:
            pass
        self.last_health = self.health_report()
        return {rid: self.runs[rid].result for rid in self._order}

    # --------------------------------------------------------------- health
    def health_report(self) -> dict:
        """{run_id: status dict} across every submitted run: progress,
        resume provenance, retry/quarantine counters, per-run wall-clock
        timing (block compute / checkpoint save / retry backoff, always
        measured), and — for finished runs — the runtime's `RunHealth`
        degradation counters."""
        report = {}
        for rid in self._order:
            run = self.runs[rid]
            health = getattr(run.result, "health", None)
            report[rid] = {
                "done": run.done,
                "quarantined": run.quarantined,
                "rounds_done": int(run.state.rounds_done),
                "iterations": int(run.state.iterations),
                "resumed": run.resumed,
                "fallback_resume": run.fallback_resume,
                "total_retries": run.total_retries,
                "last_error": run.last_error,
                "health": (dataclasses.asdict(health)
                           if health is not None else None),
                "timing": {
                    "blocks_run": run.blocks_run,
                    "block_seconds": run.block_seconds,
                    "ckpt_save_seconds": run.ckpt_save_seconds,
                    "backoff_seconds": run.backoff_seconds,
                },
            }
        return report
