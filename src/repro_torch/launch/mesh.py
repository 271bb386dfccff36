"""The client mesh of the port: the flat engine's client axis over ranks.

The counterpart of ``repro.launch.mesh.make_client_mesh``.  The reference
is single-controller: one process drives a 1-D ``jax.sharding.Mesh`` of
XLA devices, and ``shard_map`` + ``psum`` reduce the per-shard gradient
sums.  PyTorch has no such controller, so the port's mesh is SPMD over
``torch.distributed``: every rank runs the same
``build_experiment(spec, xs, ys, mesh=k).run(T)``, keeps its own block of
client rows, and one ``all_reduce`` of the (sum, count) pair a round
replaces the psum (`repro_torch.core.fed_runtime.build_step`).

`ClientMesh` is the port's mesh object: the process group of the first k
ranks of the world, k, this rank, whether it is one of the k, and its
device.  It is a small object of its own rather than a
``torch.distributed.device_mesh.DeviceMesh``: ``mesh=1`` must run in a
plain process with no process group (as the reference runs ``mesh=1`` on
one device), and a rank outside the first k must get an object that says
so, where a DeviceMesh needs an initialized group and every one of its
ranks inside it.

`spawn` starts k ranks from Python (the tests, ``mesh_sweep --ranks`` and
``chip_smoke.py`` use it): ``spawn`` start method, a ``file://`` store in
a temporary directory, a timeout on the group's collectives and a
deadline on the join, and every survivor terminated when one rank fails.
`default_backend` is the rule for the group: NCCL only when every rank
has a card of its own, gloo otherwise (NCCL refuses two ranks of one
communicator on one GPU; gloo stages CUDA tensors through the host).

`make_production_mesh` is the compile driver's mesh
(``repro_torch.launch.dryrun``): a ``DeviceMesh`` over the default
process group, a logical mesh of 256 ranks (data 16 x model 16) or 512
(pod 2 x data 16 x model 16), the sizes the sharding policies' divisibility
rules are written against (``repro_torch.sharding.policy.AXIS_SIZE``).
The dry run builds it over a fake process group, where no rank but this
one exists.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["CLIENT_AXIS", "ClientMesh", "default_backend",
           "make_production_mesh",
           "make_client_mesh", "spawn"]

#: name of the client-partitioned mesh axis
CLIENT_AXIS = "clients"

# the groups of the first k ranks made so far, keyed by (parent, k):
# ``new_group`` is a collective of the whole parent group, so a repeated
# ``make_client_mesh(k)`` hands back the group it made the first time
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh of `size` ranks over the ``"clients"`` axis.

    ``group`` is the process group of the first `size` ranks (None for a
    one-rank mesh, whose reduction is the identity); ``rank`` is this
    process's rank in the parent group, ``member`` whether it is one of
    the `size` (its shard index is then ``rank``); ``device`` the card
    this rank computes on by default (``cuda:{rank % device_count}``,
    None without CUDA); ``backend`` the group's backend.
    """
    size: int
    rank: int = 0
    member: bool = True
    group: object = None
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    axis_names: tuple = (CLIENT_AXIS,)

    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum `buf` over the mesh in place (a no-op on one rank)."""
        if self.size > 1:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def any_(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank of the mesh; every rank waits
        until all get here: one small all-reduce, on the card under NCCL,
        on the host under gloo."""
        if self.size == 1:
            return bool(flag)
        dev = self.device if self.backend == "nccl" else "cpu"
        buf = torch.tensor([float(bool(flag))], device=dev)
        self.all_reduce_(buf)
        return bool(buf.item() > 0)

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        self.any_(False)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the default process group: (data=16,
    model=16), 256 ranks, or with `multi_pod` (pod=2, data=16, model=16),
    512 ranks.  The group must have exactly that many ranks; the card's
    device type is the default (the tests pass ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a "
            f"default process group of {need} ranks (256 single-pod, 512 "
            f"multi-pod), got {world or 'none'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _cuda_device(rank: int) -> Optional[torch.device]:
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_client_mesh(num_devices: Optional[int] = None, *,
                     group=None) -> ClientMesh:
    """The mesh of the first `num_devices` ranks of `group` (default: the
    world; all its ranks when `num_devices` is None).

    Every rank of the parent group must make the same calls in the same
    order (a new group is a collective of all of them); a rank past the
    first k gets a mesh with ``member=False``, which `build_experiment`
    refuses.  With no process group initialized the world is this one
    process: ``make_client_mesh(1)`` is a one-rank mesh whose reduction is
    the identity.  Raises the reference's ``ValueError`` when k is not in
    [1, world size].
    """
    if group is None and not dist.is_initialized():
        world, rank, parent = 1, 0, None
    else:
        parent = dist.group.WORLD if group is None else group
        world = dist.get_world_size(parent)
        rank = dist.get_rank(parent)
    k = world if num_devices is None else int(num_devices)
    if not 1 <= k <= world:
        raise ValueError(
            f"requested {k} devices for the client mesh but {world} are "
            "available (start k ranks with repro_torch.launch.mesh.spawn "
            "or torchrun, one rank a device)")
    if k == 1:
        return ClientMesh(size=1, rank=rank, member=rank == 0,
                          device=_cuda_device(rank))
    if k == world:
        sub = parent
    else:
        key = (id(parent), k)
        if key not in _GROUPS:
            ranks = dist.get_process_group_ranks(parent)[:k]
            # the parent rides along so that its id cannot be reused
            _GROUPS[key] = (parent, dist.new_group(ranks=ranks))
        sub = _GROUPS[key][1]
    return ClientMesh(size=k, rank=rank, member=rank < k, group=sub,
                      device=_cuda_device(rank),
                      backend=dist.get_backend(parent))


def default_backend(k: int) -> str:
    """NCCL when every one of k ranks has a card of its own, else gloo."""
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and k <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _rank_main(fn, rank: int, k: int, backend: str, store: str,
               timeout: float, results, args) -> None:
    """One spawned rank: join the group, run ``fn(rank, *args)``, report
    its return value (or its traceback) to the parent."""
    try:
        dev = _cuda_device(rank)
        if dev is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=store, rank=rank, world_size=k,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, *args)
    except BaseException:          # reported, then this process ends
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn: Callable, k: int, *, args: tuple = (),
          timeout: float = 60.0, deadline: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` on k fresh ranks of one process group and
    return their results in rank order.

    `fn` must be importable by name (the ranks start from a fresh import)
    and return something picklable: NumPy arrays, not tensors.  The group
    (its backend by `default_backend`) rendezvouses through a
    ``file://`` store in a temporary directory, so concurrent spawns never
    share a port.  `timeout` (seconds) bounds each of the group's
    collectives (a rank waiting on one that failed then raises);
    `deadline` (seconds, default `timeout`) bounds the whole run.  Past
    the deadline, or as soon as one rank fails, every rank still alive is
    terminated and ``RuntimeError`` names each rank's error.
    """
    k = int(k)
    if k < 1:
        raise ValueError(f"k={k} ranks: need at least one")
    backend = default_backend(k)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="client_mesh_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, k, backend, store, timeout,
                                   results, args))
                 for r in range(k)]
        limit = timeout if deadline is None else float(deadline)
        end = time.monotonic() + limit
        started = []
        try:
            for p in procs:
                p.start()
                started.append(p)
            while len(done) < k and not errors:
                left = end - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if (r not in done and p.exitcode is not None
                                and p.exitcode != 0):
                            errors[r] = f"exited with code {p.exitcode}"
                    continue
                (done if ok else errors)[rank] = out
        finally:
            # ranks that all reported get a moment to leave the group;
            # after a failure or the deadline the survivors go at once
            grace = time.monotonic() + (10.0 if len(done) == k else 0.0)
            for p in started:
                p.join(timeout=max(0.0, grace - time.monotonic()))
            for p in started:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if errors or len(done) < k:
        lost = [r for r in range(k) if r not in done and r not in errors]
        lines = [f"rank {r}: {errors[r]}" for r in sorted(errors)]
        why = ("terminated after another rank failed" if errors
               else f"no result within {limit} s")
        lines += [f"rank {r}: {why}" for r in lost]
        name = getattr(fn, "__name__", repr(fn))
        raise RuntimeError(f"{k}-rank spawn of {name} failed:\n"
                           + "\n".join(lines))
    return [done[r] for r in range(k)]
