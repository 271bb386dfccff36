"""The client-mesh cases of ``tests/test_torch_mesh.py`` that run on the
ranks of a spawned group.

Every rank of one 8-rank gloo group (``repro_torch.launch.mesh.spawn``)
runs `run_cases` over the same list, in the same order: the first k ranks
of the group build and run each case on the mesh of size k, the others
are refused.  This module imports torch and the port only (the ranks
start from a fresh import); the test file holds the reference side.  The
inputs are those of ``tests/test_sharded_engine.py`` (``_data``,
``_sim``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

WORLD = 8                     # ranks of the spawned group
N, L, Q, C = 8, 24, 32, 3     # tests/test_sharded_engine.py's _data
ROUNDS = 20
PADDED_ROUNDS = 15
MULTI = (8, 3)                # run_multi(iterations, realizations)
EVERY = 5                     # checkpoint_every of the resume and service
DROP_AFTER = 2                # service steps before the drop
FAIL_AT = 2                   # rank 0's checkpoint write that fails
SWEEP_PROFILES = {"uniform": {"rate_decay": 1.0, "mac_decay": 1.0},
                  "paper": {"rate_decay": 0.9, "mac_decay": 0.9}}
SWEEP = dict(iterations=8, realizations=2, schemes=("naive", "coded"))


def data(n=N, l=L, q=Q, c=C, seed=0):
    """The reference test's client data."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def spec_kwargs(mod, n, scheme, **kw) -> dict:
    """The reference test's ``_sim`` spec, for either package's config
    (a fused_embed spec embeds into q = Q)."""
    if kw.get("fused_embed"):
        kw.setdefault("rff", mod.RFFConfig(q=Q))
    return dict(fl=mod.FLConfig(n_clients=n, delta=0.25, psi=0.3, seed=3),
                train=mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                                      lr_decay_epochs=(10, 18)),
                scheme=scheme, **kw)


def trace_eval(theta):
    """The reference test's eval: (sum |theta|, 0.0)."""
    return float(theta.abs().sum()), 0.0


@dataclasses.dataclass(frozen=True)
class Case:
    """One sharded run: `kind` is "run" (``run`` with eval every round
    when `eval`), "multi" (``run_multi(*MULTI)``), "resume", "service"
    (a root a rank), "service_resume" (one root, the service dropped and
    the job submitted again), "service_write_failure" (one root, rank 0's
    FAIL_AT-th checkpoint write raising), "legacy" (``run`` and
    ``run_multi`` of the legacy engine), "sweep" (``spec.mesh = k``) or
    "refuse" (a build that must raise)."""
    id: str
    k: int
    scheme: str = "coded"
    n: int = N
    kind: str = "run"
    rounds: int = ROUNDS
    eval: bool = False
    kw: tuple = ()

    @property
    def spec_kw(self) -> dict:
        return dict(self.kw)


CASES = (
    [Case(f"{s}-k{k}", k, s, eval=True) for s in ("naive", "greedy", "coded")
     for k in (1, 2, 4, 8)]
    + [Case(f"padded-{s}", 4, s, n=6, rounds=PADDED_ROUNDS)
       for s in ("naive", "coded")]
    + [Case(f"multi-{s}-k{k}", k, s, kind="multi")
       for s in ("naive", "greedy", "coded") for k in (2, 8)]
    + [Case("multi-drift_churn-k2", 2, kind="multi",
            kw=(("channel_profile", "drift_churn"),))]
    + [Case("ideal", 2, "ideal"),
       Case("unfused", 2, kw=(("fused_coded", False),)),
       Case("partial_coded", 2, "partial_coded"),
       Case("drift_churn", 2, kw=(("channel_profile", "drift_churn"),)),
       Case("secure", 2, kw=(("secure_aggregation", True),)),
       Case("resume", 2, kind="resume", kw=(("checkpoint_every", EVERY),)),
       Case("service", 2, kind="service", kw=(("checkpoint_every", EVERY),)),
       Case("service-resume", 2, kind="service_resume",
            kw=(("checkpoint_every", EVERY),)),
       Case("service-write-failure", 2, kind="service_write_failure",
            kw=(("checkpoint_every", EVERY),)),
       Case("legacy", 2, kind="legacy", kw=(("engine", "legacy"),)),
       Case("sweep", 2, "naive", kind="sweep"),
       Case("refuse-adaptive", 2, "adaptive_coded", kind="refuse",
            kw=(("adapt_every", 2),)),
       Case("refuse-return-faults", 2, kind="refuse",
            kw=(("fault_profile", "flaky_clients"),)),
       Case("refuse-fused_embed", 2, kind="refuse",
            kw=(("fused_embed", True),)),
       Case("refuse-hier", 2, kind="refuse", kw=(("hier_shards", 2),))])


def to_port(carried: dict) -> dict:
    """The reference's draws of a case (NumPy) as the port's build
    arguments, through ``repro_torch.carry``."""
    from repro_torch import carry
    out = {}
    if "parity_generators" in carried:
        out["parity_generators"] = carry.generators_from_reference(
            carried["parity_generators"], device="cpu")
    if "secure_masks" in carried:
        out["secure_masks"] = carry.secure_masks_from_reference(
            *carried["secure_masks"], device="cpu")
    return out


def _history(res) -> dict:
    return {"theta": res.theta.numpy(),
            "wall": [h.wall_clock for h in res.history],
            "returned": [h.returned for h in res.history],
            "loss": [h.loss for h in res.history],
            "n_masked": [h.n_masked for h in res.history]}


def _multi(res) -> dict:
    return {"theta": res.theta.numpy(), "wall": res.wall_clock,
            "returned": res.returned}


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _service_job(case: Case, spec, carried: dict, root: str,
                 rank: int) -> dict:
    """A job of `case` through ``ExperimentService(root, mesh=k)`` with
    spans on (so it is journaled): its history, rank 0's events.jsonl,
    the files under the root, and each failed block's error."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch.service import ExperimentService
    from repro_torch.obs import spans

    xs, ys = data(case.n)
    save = ckpt_io.save_state
    writes = []

    def failing_save(path, arrays, meta):
        writes.append(path)
        if len(writes) == FAIL_AT:
            raise OSError(f"no space left on device (injected): {path}")
        return save(path, arrays, meta)

    out = {"errors": []}
    spans.reset()
    spans.enable()
    try:
        if case.kind == "service_write_failure" and rank == 0:
            ckpt_io.save_state = failing_save
        svc = ExperimentService(root, device="cpu", mesh=case.k)
        run = svc.submit(spec, xs, ys, case.rounds, run_id="job",
                         **carried)
        if case.kind == "service_resume":
            for _ in range(DROP_AFTER):
                svc.step()
            # the service is dropped; a new one finds the job's
            # checkpoints, which rank 0 wrote, under the shared root
            svc = ExperimentService(root, device="cpu", mesh=case.k)
            run = svc.submit(spec, xs, ys, case.rounds, run_id="job",
                             **carried)
            out["resumed"] = run.resumed
            out["resumed_at"] = int(run.state.rounds_done)
        while svc.step() is not None:
            if run.last_error is not None:
                out["errors"].append(run.last_error)
        res = run.result
        out["total_retries"] = run.total_retries
        out["quarantined"] = run.quarantined
    finally:
        ckpt_io.save_state = save
        spans.disable()
        spans.reset()
    out.update(_history(res))
    events = os.path.join(root, "job", "events.jsonl")
    # under a shared root rank 0 may still be journaling: it alone reads
    shared = case.kind != "service"
    out["events"] = (open(events, "rb").read() if os.path.exists(events)
                     and not (shared and rank) else None)
    out["files"] = _files(root)
    return out


def _run_case(case: Case, carried: dict, tmp: str, rank: int):
    from repro_torch import api
    from repro_torch import config as t_config
    from repro_torch.checkpoint import io as ckpt_io

    if case.kind == "sweep":
        xs, ys = data(case.n)
        spec = t_config.ExperimentSpec(
            **spec_kwargs(t_config, case.n, case.scheme, mesh=case.k))
        exp = api.build_experiment(spec, xs, ys, device="cpu")
        sw = exp.sweep(profiles=SWEEP_PROFILES, **SWEEP)
        return {s: {p: _multi(m) for p, m in per.items()}
                for s, per in sw.results.items()}
    xs, ys = data(case.n)
    spec = t_config.ExperimentSpec(
        **spec_kwargs(t_config, case.n, case.scheme, **case.spec_kw))
    kw = dict(device="cpu", mesh=case.k, **carried)
    if case.kind == "service":
        root = os.path.join(tmp, "service", f"rank{rank}")
        return _service_job(case, spec, carried, root, rank)
    if case.kind.startswith("service_"):
        # one root for every rank, as on a shared file system
        return _service_job(case, spec, carried,
                            os.path.join(tmp, case.id), rank)
    if case.kind == "refuse":
        try:
            api.build_experiment(spec, xs, ys, **kw)
        except (ValueError, NotImplementedError) as exc:
            return {"error": type(exc).__name__, "message": str(exc)}
        return {"error": None}
    exp = api.build_experiment(spec, xs, ys, **kw)
    if case.kind == "multi":
        return _multi(exp.run_multi(*MULTI))
    if case.kind == "legacy":
        out = _history(exp.run(case.rounds))
        out["multi"] = _multi(exp.run_multi(*MULTI))
        return out
    if case.kind == "resume":
        whole = exp.run(case.rounds,
                        checkpoint_dir=os.path.join(tmp, "resume_whole"))
        # killed after one block: a fresh experiment resumes the file
        # rank 0 wrote
        killed_dir = os.path.join(tmp, "resume_killed")
        dead = api.build_experiment(spec, xs, ys, **kw)
        state = dead.run_block(dead.init_state(case.rounds))
        dead.save_state(os.path.join(
            killed_dir, f"{ckpt_io.CKPT_PREFIX}{state.rounds_done:06d}.npz"),
            state)
        fresh = api.build_experiment(spec, xs, ys, **kw)
        resumed = fresh.run(case.rounds, checkpoint_dir=killed_dir,
                            resume=True)
        return {"whole": _history(whole), "resumed": _history(resumed),
                "files": _files(killed_dir)}
    if case.eval:
        return _history(exp.run(case.rounds, eval_fn=trace_eval,
                                eval_every=1))
    return _history(exp.run(case.rounds))


def run_cases(rank: int, cases, carried: dict, tmp: str) -> dict:
    """Every case on this rank: ``{case id: result}``, where a rank past a
    case's k holds ``{"refused": message}`` (the refusal naming it)."""
    from repro_torch.launch.mesh import make_client_mesh

    torch.set_num_threads(1)
    out = {}
    for case in cases:
        if rank >= case.k:
            # the non-members take part in making the group, then are
            # refused by the build
            from repro_torch import api
            from repro_torch import config as t_config
            make_client_mesh(case.k)
            xs, ys = data(case.n)
            spec = t_config.ExperimentSpec(**spec_kwargs(t_config, case.n,
                                                         "naive"))
            try:
                api.build_experiment(spec, xs, ys, device="cpu",
                                     mesh=case.k)
            except ValueError as exc:
                out[case.id] = {"refused": str(exc)}
            continue
        out[case.id] = _run_case(case, to_port(carried.get(case.id, {})),
                                 tmp, rank)
    return out


def fail_on_rank_one(rank: int) -> None:
    """Rank 1 raises while rank 0 waits in an all-reduce."""
    if rank == 1:
        raise RuntimeError("rank one failed on purpose")
    torch.distributed.all_reduce(torch.zeros(1))
