"""Multi-pod dry run: trace one step of every (arch x input-shape x mesh)
combination over DTensor on a fake process group, and count one rank's
roofline inputs (the counterpart of ``repro.launch.dryrun``).

PyTorch has no XLA partitioner to lower and compile a step for a mesh of
placeholder devices.  Its counterpart here is DTensor: for each
combination this driver

  1. makes a fake process group of 256 or 512 ranks (backend ``"fake"``:
     every collective returns at once, no other rank exists) and the
     production mesh over it (16x16 single-pod / 2x16x16 multi-pod,
     ``repro_torch.launch.mesh.make_production_mesh``),
  2. builds the params, the batch and the cache on the ``meta`` device
     (shapes and dtypes, no storage) and turns every leaf into a DTensor
     with the placements of the reference's sharding policy
     (``repro_torch.sharding.policy``), so that each holds this rank's
     local block,
  3. runs the step once on them: train (`loss_fn`, its gradient, and
     ``p - 1e-3 g`` cast back to p's dtype, with `microbatch` gradient
     accumulation in float32), prefill, or one decode step,
  4. counts what this rank's local ops do, with `StepCounter`, a dispatch
     mode that lets DTensor desugar each op into local ops and
     collectives first and sees only those,
  5. writes a JSON record with the reference's keys, which
     ``benchmarks/roofline.py`` reads.

What the record's numbers mean (one rank, rank 0, of the mesh):

  * ``flops_per_device``: the FLOPs of this rank's local ops, by the
    formulas of ``torch.utils.flop_counter`` (matrix products, attention
    and convolutions; element-wise ops count none) on the local blocks'
    shapes.  ``FlopCounterMode`` around DTensor would count each op at
    its global shape.
  * ``bytes_per_device``: for every local op that moves data (views,
    ``_unsafe_view``, ``empty`` and the collectives' waits excluded), the
    bytes of its tensor inputs, each read once, plus those of its
    outputs, each written once.  No op is fused, so this is an upper
    bound of what a compiler's fused program would move.
  * ``collective_bytes_per_device``: the result bytes of each collective
    this rank issues, under the reference's five HLO names (torch's
    functional collectives mapped onto them: `COLLECTIVE_OPS`).
  * ``memory_analysis``: ``argument_size_in_bytes``, the local blocks of
    the step's arguments (split into params, batch and cache under
    ``argument_bytes``); ``output_size_in_bytes``, those of its results;
    ``temp_size_in_bytes``, the peak of the local bytes that ops made
    during the step and that were still alive (activations, saved
    tensors, gradients, the results), which lie above the arguments.
    There is no code generation, so ``generated_code_size_in_bytes`` is
    left out, as the reference leaves out what its analysis lacks.
  * ``compile_seconds``: the seconds of the trace (host work).

The trace and the reference's compiled program differ where DTensor's
rules differ from XLA's partitioner: DTensor picks each op's strategy by
its own redistribution costs, and it refuses a view that splits an
unevenly sharded dim.  At such a view the driver replicates the input's
sharded mesh dims, innermost first, until the view goes through
(`DispatchRoutes`), and it steps in at a few more places where DTensor
cannot go on by itself (`Redistributor`); each place is recorded under
``redistributions``, and the model's math is not changed for any.  The
counts do not depend on the installed torch (2.11 and 2.13 agree): no op
goes through a DTensor mechanism that only some versions have (an op
that some version's DTensor has no sharding strategy for takes the
driver's own route, `ROUTED`; the record counts the calls under
``routed``), and wherever versions would choose differently the driver
chooses (partial sums reduced where they are made, in the backward too;
pointwise operands placed alike; each gradient brought to its
parameter's placements; every redistribution one mesh dim at a time).
Plain tensors made inside the layers (rope frequencies, zero states,
positions) are replicated
(``implicit_replication``).  A decode step's attention goes through the
plain version of the ``gqa_decode`` kernel on ``meta`` (the record says
so under ``decode_attention``).  The reference's
``normalize_cost_analysis``, which flattens the drift of XLA's
``cost_analysis`` API, has no counterpart: the counts are the driver's
own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--policy tp_only]
  (add ``--device cpu`` where there is no card: the mesh's device type,
  which decides how DTensor decomposes some collectives)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._redistribute import redistribute_local_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.carry import _cache_leaves, _layer_leaves
from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, decode_window, get_config, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, transformer
from repro_torch.models.model_zoo import build
from repro_torch.sharding import policy as sh

POLICIES = ["fsdp_tp", "tp_only", "dp_only", "fsdp_tp_ep", "tp_only_ep"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: torch's collective ops (``namespace.name``) by the reference's HLO names
COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "_c10d_functional.isend": "collective-permute",
    "_c10d_functional.irecv": "collective-permute",
    "_c10d_functional.batch_p2p_ops": "collective-permute",
}
# ops of the collective namespaces that move no data of their own
_COLLECTIVE_NOOPS = {"_c10d_functional.wait_tensor",
                     "_c10d_functional._wrap_tensor_autograd"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
# ops that move no data: allocations, and a view by another name (DTensor
# runs a reshape's local op as `_unsafe_view` in some torch versions and
# as `view` in others)
_NO_BYTES = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten._unsafe_view"}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def collective_bytes(records) -> dict[str, int]:
    """Sum per-rank result bytes of collectives by the reference's names.

    `records`: (op name ``namespace.name``, result bytes) pairs, as
    `StepCounter` collects them.  An op of a collective namespace that
    `COLLECTIVE_OPS` does not name raises, so that no traffic is dropped
    unseen."""
    out = {k: 0 for k in _COLLECTIVES}
    for name, nbytes in records:
        if name in _COLLECTIVE_NOOPS:
            continue
        if name not in COLLECTIVE_OPS:
            raise ValueError(f"collective op {name} has no HLO name")
        out[COLLECTIVE_OPS[name]] += nbytes
    return out


def _fake_mode_active() -> bool:
    """True inside a FakeTensorMode: DTensor's sharding propagation runs
    each new op once at its global shapes there, which no rank runs."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class StepCounter(TorchDispatchMode):
    """Counts one rank's local work: FLOPs, bytes, collectives and the
    live bytes of what ops make.

    An op on DTensors is handed back (``NotImplemented``) so DTensor
    desugars it first into local ops and collectives, which this mode then
    sees.  Not counted: ops that DTensor's sharding propagation runs at
    global shapes under a FakeTensorMode, and ops on no ``meta`` tensor
    (the mesh's bookkeeping on small CPU tensors; the step's tensors all
    live on ``meta``).  `live` tracks each storage an
    op makes until it is freed; `peak` is the most live bytes at once."""

    def __init__(self):
        super().__init__()
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._storages: set = set()

    def _free(self, key, nbytes):
        self._storages.discard(key)
        self.live -= nbytes

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages.add(key)
            nbytes = st.nbytes()
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _fake_mode_active() or not any(
                t.is_meta for t in _tensors((args, kwargs, out))):
            return out
        packet = func._overloadpacket
        name = f"{func.namespace}.{packet.__name__}"
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collectives.append((name, _nbytes(out)))
            if name not in _COLLECTIVE_NOOPS:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        else:
            if packet in self._flop_registry:
                self.flops += self._flop_registry[packet](
                    *args, **kwargs, out_val=out)
            if not func.is_view and name not in _NO_BYTES:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        self._track(out)
        return out


_NEW_FACTORIES = {"new_zeros", "new_ones", "new_full", "new_empty"}
# the view ops DTensor sees (reshape, flatten, unflatten and their
# backward decompose into these)
_VIEW_OPS = {"aten.view", "aten._unsafe_view", "aten.reshape"}


def _where() -> str:
    """The model's source line that runs now, or ``backward``."""
    frame = next((f for f in reversed(traceback.extract_stack())
                  if "/repro_torch/models/" in f.filename
                  or "/repro_torch/kernels/" in f.filename), None)
    return ("backward" if frame is None else
            f"{frame.filename.split('/src/')[-1]}:{frame.lineno}")


class Places:
    """The places where the driver redistributed, counted by (source
    line, op, global shape, placements before, placements after)."""

    def __init__(self):
        self.count: dict = {}

    def add(self, op: str, x, y) -> None:
        key = (_where(), op, tuple(x.shape), str(tuple(x.placements)),
               str(tuple(y.placements)))
        self.count[key] = self.count.get(key, 0) + 1

    def report(self) -> list[dict]:
        return [{"where": w, "op": op, "shape": list(shape), "from": a,
                 "to": b, "count": n}
                for (w, op, shape, a, b), n in sorted(self.count.items())]


# the products whose partial sums are reduced at once
_PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "einsum",
             "linear"}


def _reduced(out):
    """A DTensor's partial sums reduced (all-reduce: replicated on those
    mesh dims); anything else as it is."""

    if not isinstance(out, DTensor) or not any(
            isinstance(p, Partial) for p in out.placements):
        return out
    return _brought(out, [Replicate() if isinstance(p, Partial) else p
                          for p in out.placements])


def _lookup(name, args, kwargs):
    """An ``embedding`` or ``gather`` call with its looked-up DTensor's
    partial sums reduced first: (args, (x, index, dim, embedding) for
    `_sharded_lookup`: every gather from a DTensor, an embedding where the
    table is sharded by rows; else None)."""

    if name == "embedding" and len(args) >= 2:
        at, index, dim = 1, args[0], 0
    elif name == "gather" and len(args) >= 3 and not kwargs:
        at, index, dim = 0, args[2], args[1]
    else:
        return args, None
    x = args[at]
    if not isinstance(x, DTensor):
        return args, None
    if any(isinstance(p, Partial) for p in x.placements):
        x = _reduced(x)
        args = args[:at] + (x,) + args[at + 1:]
    dim = dim % x.ndim
    if name == "embedding" and not any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        return args, None
    return args, (x, index, dim, name == "embedding")


class Redistributor(TorchFunctionMode):
    """Redistributes where DTensor cannot go on by itself (each place
    recorded in `places`, a `Places`):

      * A lookup along a sharded dim (the embedding of a vocab-sharded
        table, the cross-entropy's gather of the label logits from
        vocab-sharded logits): DTensor's own gives a partial sum that
        carries its lookup mask, which it can reduce only once (the model
        reads the embedding twice, the norm and the residual) and whose
        backward compares masks by value (``meta`` has none).  The driver
        looks the index up in each rank's slice itself (`_sharded_lookup`)
        and reduces (replicates) the partial sum right after, as a
        vocab-parallel layer does.
      * ``new_zeros`` and its kin on a DTensor make a replicated DTensor
        of the global shape: DTensor would give it the source's sharding,
        which an uneven first dim (the MoE dispatch buffer's E * cap + 1
        rows) breaks in later views.  An in-place op on a replicated
        DTensor (that buffer's ``index_copy_``) takes its other operands
        replicated: DTensor would otherwise change the buffer's
        placements without moving its data.
      * A write into a slice of a sharded DTensor (a cache's slot writes
        at decode and its prompt writes at prefill), which DTensor would
        make on a gathered copy, is made by the owning rank into its own
        block (`_owner_setitem`; not recorded).

    A product whose result is a partial sum (a contraction over a
    sharded dim: the row-parallel projections wo, w2, out_proj) is
    reduced at once, as a tensor-parallel layer reduces its output.
    DTensor would keep the sum partial and turn each replicated operand
    it meets into a partial one (the residual stream after the first
    layer), until an op that needs the values gathers a full-vocab
    ``lm_head`` or the logits of every rank.

    It also gives the FSDP axis its meaning: a parameter sharded over
    `data` is gathered over it (all-gather) where an op reads it, so its
    gradient comes back reduce-scattered, as a fully sharded data-parallel
    layer's does; `model` shards stay put (tensor parallel).  The update
    reads the shards through ``detach``, which gathers nothing.  Without
    this, DTensor's per-op choice contracts over the FSDP-sharded dim and
    leaves partial sums that later ops gather whole (the KV cache of a
    decode step, hundreds of GB a rank).  `fsdp` maps the ids of those
    parameters to the ``data`` mesh dim; gathers are not recorded.

    A view DTensor refuses, an op some DTensor version has no strategy
    for, and a partial sum a backward op makes are `DispatchRoutes`'s, at
    the dispatcher, where the backward's ops pass too."""

    def __init__(self, places: Places, fsdp=()):
        super().__init__()
        self.places = places
        self.fsdp = dict(fsdp)

    def _gather(self, a):
        m = self.fsdp.get(id(a))
        if m is None:
            return a
        place = list(a.placements)
        place[m] = Replicate()
        return a.redistribute(a.device_mesh, place)

    def _replicated(self, name, a):
        if not isinstance(a, DTensor) or all(
                isinstance(p, Replicate) for p in a.placements):
            return a
        y = _brought(a, [Replicate()] * a.device_mesh.ndim)
        self.places.add(name, a, y)
        return y

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if self.fsdp and name != "detach":
            args = tuple(self._gather(a) if isinstance(a, DTensor) else a
                         for a in args)
        if name == "__setitem__" and isinstance(args[0], DTensor) \
                and _owner_setitem(*args):
            return None
        args, lookup = _lookup(name, args, kwargs)
        if lookup is not None:
            out = _sharded_lookup(*lookup)
            if not any(isinstance(p, Partial) for p in out.placements):
                return out
            y = _reduced(out)
            self.places.add(name, out, y)
            return y
        if name in _PRODUCTS:
            return _reduced(func(*args, **kwargs))
        if name.endswith("_") and not name.startswith("_") and args \
                and isinstance(args[0], DTensor) and all(
                    isinstance(p, Replicate) for p in args[0].placements):
            args = (args[0],) + tuple(self._replicated(name, a)
                                      for a in args[1:])
        if name in _NEW_FACTORIES and isinstance(args[0], DTensor):
            mesh = args[0].device_mesh
            return DTensor.from_local(
                func(args[0].to_local(), *args[1:], **kwargs), mesh,
                [Replicate()] * mesh.ndim, run_check=False)
        return func(*args, **kwargs)


class DispatchRoutes(TorchDispatchMode):
    """The driver's routes at the dispatcher, where the backward's ops pass
    too.  It sits above `StepCounter`, so the collectives of each
    redistribution and the local ops are counted.

      * A view DTensor refuses or fails (one that splits an unevenly
        sharded dim, or a shard that does not align with the new dims: a
        256-way shard of the B * S rows viewed as (B, S) gives a local
        view of the wrong size), or a view that gives a strided shard (a
        merge of sharded dims, whose every later redistribution DTensor
        plans by a graph search, ~1 s each on the 2x16x16 mesh): the
        input's sharded mesh dims are replicated, innermost first, one
        more at a time, until the view goes through to plain placements;
        each place recorded in `places`.
      * An op of `ROUTED` (one that some torch version's DTensor has no
        sharding strategy for) never reaches DTensor's sharding
        propagation: its operands are brought to the placements its rule
        names, the op runs on the local tensors, and its result takes the
        rule's placements (`_route`); each call counted in `routed`, each
        operand it moved recorded in `places`.
      * A pointwise op whose operands disagree on a mesh dim takes them
        placed alike (`_pointwise_pinned`): a replicated operand sharded
        as another is (a local slice: no collective), where a torch
        version might gather the sharded one instead; operands sharded
        on different dims as the first one is.
      * A result that is a partial sum is reduced where it is made
        (all-reduce), as a tensor-parallel layer reduces its output and
        its input's gradient: in the forward (and a checkpointed layer's
        recompute) over every mesh dim, in the backward over ``model``
        only.  A partial sum over the batch's mesh dims in the backward
        is a weight's gradient, summed over the batch: the FSDP gather's
        backward reduce-scatters it, the update brings the rest to their
        parameters' placements (`_grad`, `build_step`).  DTensor would
        carry each partial sum on and choose, op by op and differently
        in each torch version, where to reduce it (a product of a partial
        gradient with a gathered weight runs whole on every rank; the
        update of a replicated weight leaves it partial)."""

    def __init__(self, places: Places):
        super().__init__()
        self.places = places
        self.routed: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = f"{func.namespace}.{func._overloadpacket.__name__}"
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if name in ROUTED:
            self.routed[name] = self.routed.get(name, 0) + 1
            return _route(name, func, args, kwargs, self.places)
        if name in _VIEW_OPS and isinstance(args[0], DTensor):
            out = self._view(name, func, args, kwargs)
        else:
            if torch.Tag.pointwise in func.tags:
                args = _pointwise_pinned(args, func._schema.is_mutable)
            out = func(*args, **kwargs)
        if func._schema.is_mutable or func.is_view:
            return out        # an alias of an operand: reduced where made
        return _partials_reduced(out, model_only=_BACKWARD[0] > 0
                                 and not torch.is_grad_enabled())

    def _view(self, name, func, args, kwargs):
        err = None
        try:
            out = func(*args, **kwargs)
            if not _strided(out):
                return out
        except RuntimeError as e:
            err = e
        x = args[0]
        place = list(x.placements)
        for m in reversed(range(len(place))):
            if place[m].is_replicate() or place[m].is_partial():
                continue
            place[m] = Replicate()
            y = _moved(x, place)
            try:
                out = func(y, *args[1:], **kwargs)
            except RuntimeError:
                continue
            if _strided(out):
                continue
            self.places.add(name, x, y)
            return out
        if err is not None:
            raise err
        return out


#: > 0 inside `_grad`: the backward (where grad mode is off)
_BACKWARD = [0]


def _partials_reduced(out, model_only: bool):
    """`out` with its partial sums reduced (replicated) over every mesh
    dim, or over ``model`` only, also in a tuple or list; anything else
    as it is."""
    if isinstance(out, (tuple, list)):
        return type(out)(_partials_reduced(o, model_only) for o in out)
    if not isinstance(out, DTensor):
        return out
    names = out.device_mesh.mesh_dim_names
    return _moved(out, [Replicate() if p.is_partial() and (
        not model_only or names[m] == sh.MODEL) else p
        for m, p in enumerate(out.placements)])


def _pointwise_pinned(args, inplace: bool) -> tuple:
    """The DTensor operands of a pointwise op (every one but the first of
    an in-place op) placed alike on each mesh dim where they disagree and
    none is a partial sum: where one operand shards a dim of the
    broadcast shape, an operand replicated there and spanning that dim
    whole is sharded alike (a local slice); where operands shard
    different dims, each takes the first operand's shard (or is
    replicated, where the first is or where it spans the dim only by
    broadcasting)."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if len(dts) < 2:
        return args
    nd = max(a.ndim for a in dts)
    shape = torch.broadcast_shapes(*(tuple(a.shape) for a in dts))
    mesh = dts[0].device_mesh
    new = {}
    for m in range(mesh.ndim):
        ps = [a.placements[m] for a in dts]
        if any(p.is_partial() for p in ps):
            continue
        dims = {p.dim + nd - a.ndim for a, p in zip(dts, ps)
                if isinstance(p, Shard)}
        if not dims:
            continue
        one = len(dims) == 1
        d = next(iter(dims)) if one else (
            ps[0].dim + nd - dts[0].ndim if isinstance(ps[0], Shard)
            else None)
        for i, (a, p) in enumerate(zip(dts, ps)):
            if inplace and a is args[0]:
                continue
            ld = None if d is None else d - (nd - a.ndim)
            if ld is not None and ld >= 0 and a.shape[ld] == shape[d]:
                want = Shard(ld)
            elif one:
                continue          # spans the dim by broadcasting: as it is
            else:
                want = Replicate()
            if p != want:
                new.setdefault(i, list(a.placements))[m] = want
    if not new:
        return args
    out, i = [], 0
    for a in args:
        if isinstance(a, DTensor):
            if i in new:
                a = _moved(a, new[i])
            i += 1
        out.append(a)
    return tuple(out)


def _brought(a, place):
    """DTensor `a` redistributed to `place` one mesh dim at a time, in
    order (no call where it is there): each step one collective or none,
    whatever plan a torch version's redistribution would make of them
    together."""
    for m, p in enumerate(place):
        if a.placements[m] != p:
            step = list(a.placements)
            step[m] = p
            a = a.redistribute(a.device_mesh, step)
    return a


def _moved(a, place):
    """`_brought` for the dispatcher's routes: each step on the local
    tensor (``redistribute_local_tensor``, the collectives
    ``DTensor.redistribute`` makes) and wrapped anew, outside autograd
    (below it, where a route runs, autograd records nothing; in the
    backward, torch 2.11's autograd would ``detach_`` a redistribution's
    result that views its input, an op DTensor has no strategy for)."""
    for m, p in enumerate(place):
        if a.placements[m] != p:
            step = list(a.placements)
            step[m] = p
            local = redistribute_local_tensor(
                a._local_tensor, a._spec, _spec(a.device_mesh, step,
                                                a._spec.tensor_meta))
            a = _wrapped(local, a.device_mesh, step, a._spec.tensor_meta)
    return a


def _spec(mesh, place, meta) -> DTensorSpec:
    return DTensorSpec(mesh, tuple(place), tensor_meta=meta)


def _wrapped(local, mesh, place, meta):
    """A DTensor of `local` with `place` and global `meta` (shape,
    stride, dtype), made directly, outside autograd."""
    return DTensor(local, _spec(mesh, place, meta), requires_grad=False)


def _as_dtensor(t, mesh):
    """A plain tensor as the replicated DTensor implicit replication makes
    of it; anything else as it is."""
    if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
        return t
    return _wrapped(t, mesh, [Replicate()] * mesh.ndim,
                    TensorMeta(t.shape, t.stride(), t.dtype))


def _unsharded(place, dims) -> list:
    """`place` with every Shard of a tensor dim in `dims` and every
    Partial replaced by Replicate."""
    return [Replicate() if p.is_partial() or (
        isinstance(p, Shard) and p.dim in dims) else p for p in place]


def _index_rule(args, kwargs, inplace: bool):
    """``index_copy(_)`` / ``index_add(_)`` (self, dim, index, source):
    self unsharded along `dim` (an in-place op's self must be so
    already), the index replicated, the source sharded as self is on its
    other dims and replicated elsewhere; the result is sharded as self."""
    x, dim, index, source = args[:4]
    dim = dim % x.ndim
    place = _unsharded(x.placements, {dim})
    if inplace and place != list(x.placements):
        raise ValueError(f"in-place index op into {x.placements} along "
                         f"dim {dim}")
    mesh = x.device_mesh
    src_place = [p if isinstance(p, Shard) else Replicate() for p in place]
    return ([place, [Replicate()] * mesh.ndim, src_place], place)


def _index_select_rule(args, kwargs, inplace: bool):
    """``index_select(self, dim, index)``: self unsharded along `dim`; on
    a mesh dim where the index is sharded and self then replicated, the
    result is sharded along `dim` as the index is, elsewhere the index is
    replicated and the result sharded as self."""
    x, dim, index = args[:3]
    dim = dim % x.ndim
    place = _unsharded(x.placements, {dim})
    index_place, out = [], []
    for p, q in zip(place, index.placements):
        shard = isinstance(q, Shard) and p.is_replicate()
        index_place.append(q if shard else Replicate())
        out.append(Shard(dim) if shard else p)
    shape = list(x.shape)
    shape[dim] = index.shape[0]
    return ([place, index_place], out, tuple(shape))


def _scatter_rule(args, kwargs, inplace: bool):
    """``scatter`` (self, dim, index, src or value): every operand
    unsharded along `dim` and sharded as self is on a dim where each
    operand spans self's length (replicated elsewhere); the result is
    sharded as self."""
    x, dim = args[0], args[1] % args[0].ndim
    dts = [a for a in args if isinstance(a, DTensor)]
    place = [Replicate() if p.is_partial() or (isinstance(p, Shard) and (
        p.dim == dim or any(a.shape[p.dim] != x.shape[p.dim] for a in dts)))
        else p for p in x.placements]
    if inplace and place != list(x.placements):
        raise ValueError(f"in-place scatter into {x.placements} along "
                         f"dim {dim}")
    return ([place] * len(dts), place)


def _pointwise_rule(args, kwargs, inplace: bool):
    """A pointwise op on operands of one shape: each brought to the first
    operand's placements, partial sums reduced; the result so placed."""
    dts = [a for a in args if isinstance(a, DTensor)]
    place = _unsharded(dts[0].placements, ())
    if any(tuple(a.shape) != tuple(dts[0].shape) for a in dts):
        place = [Replicate()] * dts[0].device_mesh.ndim
    return ([place] * len(dts), place)


def _flip_rule(args, kwargs, inplace: bool):
    """``flip(self, dims)``: self unsharded along the flipped dims; the
    result placed as self then is."""
    x, dims = args[0], args[1]
    place = _unsharded(x.placements, {d % x.ndim for d in dims})
    return ([place], place)


#: the ops routed by `DispatchRoutes` (no DTensor sharding strategy on
#: some torch version: torch 2.11 has none for the index ops, softplus
#: and flip, and tries index_select's decomposition before its rule;
#: 2.13 reaches the index ops and softplus_backward through its
#: decomposition fallback; the two versions place scatter's operands
#: differently), each with its placement rule: (args, kwargs, in place) ->
#: (placements of each DTensor operand, in order; the result's[; the
#: result's global shape, where it is not the first operand's])
ROUTED = {
    "aten.index_copy_": _index_rule,
    "aten.index_copy": _index_rule,
    "aten.index_add_": _index_rule,
    "aten.index_add": _index_rule,
    "aten.softplus": _pointwise_rule,
    "aten.softplus_backward": _pointwise_rule,
    "aten.flip": _flip_rule,
    "aten.scatter": _scatter_rule,
    "aten.scatter_": _scatter_rule,
    "aten.index_select": _index_select_rule,
}


def _route(name, func, args, kwargs, places):
    """`func` of a `ROUTED` op run on local tensors, its operands (a plain
    tensor among them taken as replicated) brought to its rule's
    placements first (each operand moved recorded in `places`)."""
    inplace = name.endswith("_")
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    args = tuple(_as_dtensor(a, mesh) for a in args)
    operand_place, out_place, *shape = ROUTED[name](args, kwargs, inplace)
    first = args[0]
    shape = shape[0] if shape else tuple(first.shape)
    want = iter(operand_place)
    local_args = []
    for a in args:
        if isinstance(a, DTensor):
            b = _moved(a, next(want))
            if b is not a:
                places.add(name, a, b)
            a = b._local_tensor
        local_args.append(a)
    out = func(*local_args, **kwargs)
    if inplace:
        return first
    return _wrapped(out, mesh, out_place, TensorMeta(
        torch.Size(shape), _contiguous_stride(shape), out.dtype))


def _contiguous_stride(shape) -> tuple:
    return torch.empty(tuple(shape), device="meta").stride()


def _strided(out) -> bool:
    """True for a DTensor with a ``_StridedShard`` placement (a view that
    merged a sharded dim into a coarser one)."""

    return isinstance(out, DTensor) and any(
        isinstance(p, _StridedShard) for p in out.placements)


def _sharded_lookup(x, index, dim: int, embedding: bool):
    """A lookup along `dim` of a DTensor `x` made on the local blocks.
    Where `x` is sharded on that dim, as a vocab-parallel layer makes it:
    each rank looks `index` up in its own slice of the dim and zeros the
    rest, a partial sum over those mesh dims, which the caller reduces.
    (A gather along an unsharded dim is made locally too: DTensor's own
    backward of it makes the zeros of the input's global shape on every
    rank.)  ``F.embedding(index, x)`` (rows,
    `dim` 0) with `embedding`, else ``x.gather(dim, index)``; on the other
    mesh dims the output takes `x`'s placements (the index is brought to
    them), or the index's for an embedding."""

    mesh = x.device_mesh
    along = [isinstance(p, Shard) and p.dim == dim for p in x.placements]
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    keep = index.placements if embedding else x.placements
    index = _brought(index, [Replicate() if a else p
                             for a, p in zip(along, keep)])
    lshape, off = compute_local_shape_and_global_offset(
        x.shape, mesh, x.placements)
    local = index.to_local().long()
    if any(along):
        local = local - off[dim]
        ok = (local >= 0) & (local < lshape[dim])
        local = torch.where(ok, local, 0)
    if embedding:
        out = F.embedding(local, x.to_local()) * ok[..., None]
        shape = tuple(index.shape) + (x.shape[1],)
    else:
        out = x.to_local().gather(dim, local)
        out = out * ok if any(along) else out
        shape = tuple(index.shape)
    return DTensor.from_local(
        out, mesh, [Partial() if a else p for a, p in zip(along, keep)],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _owner_setitem(dst, index, value) -> bool:
    """``dst[index] = value`` for a DTensor `dst` sharded by `Shard`s,
    made where the data lives: this rank writes the part of the indexed
    region inside its own block (nothing where it owns none of it), with
    `value` brought to the same sharding on the dims the index keeps whole
    and replicated on the others.  An index of ints and unit-step slices
    only; False (DTensor's own ``__setitem__`` goes on) for anything
    else."""

    index = index if isinstance(index, tuple) else (index,)
    if any(not isinstance(i, (int, slice)) for i in index) \
            or len(index) > dst.ndim \
            or not all(isinstance(p, (Shard, Replicate))
                       for p in dst.placements):
        return False
    shape = tuple(dst.shape)
    lshape, off = compute_local_shape_and_global_offset(
        shape, dst.device_mesh, dst.placements)
    local, kept = [], []          # kept: (dst dim, lo, hi, length indexed)
    for d in range(dst.ndim):
        i = index[d] if d < len(index) else slice(None)
        if isinstance(i, int):
            i = i + shape[d] if i < 0 else i
            if not off[d] <= i < off[d] + lshape[d]:
                return True                       # not this rank's
            local.append(i - off[d])
            continue
        start, stop, step = i.indices(shape[d])
        if step != 1:
            return False
        lo, hi = max(start, off[d]), min(stop, off[d] + lshape[d])
        if hi <= lo:
            return True
        local.append(slice(lo - off[d], hi - off[d]))
        kept.append((d, lo - start, hi - start, stop - start))
    if isinstance(value, torch.Tensor):
        kept = kept[len(kept) - value.ndim:]      # broadcast from the right
        whole = {}                                # value dim -> dst dim
        for j, (d, lo, hi, n) in enumerate(kept):
            if n == shape[d] and value.shape[j] == n:
                whole[d] = j
        if isinstance(value, DTensor):
            target = [Shard(whole[p.dim]) if isinstance(p, Shard)
                      and p.dim in whole else Replicate()
                      for p in dst.placements]
            value = _brought(value, target).to_local()
            done = {t.dim for t in target if isinstance(t, Shard)}
        else:
            done = set()
        value = value[tuple(
            slice(None) if j in done or value.shape[j] == 1
            else slice(lo, hi) for j, (d, lo, hi, n) in enumerate(kept))]
    dst.to_local()[tuple(local)] = value
    return True


def _distribute(t, spec, mesh):
    """A meta tensor as a DTensor on `mesh` with `spec`'s placements: this
    rank's local block, no communication."""
    return distribute_tensor(t.detach(), mesh, sh.placements(spec, mesh),
                             src_data_rank=None)


def _local_bytes(obj) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in _tensors(obj))


def _distribute_params(params, policy: str, mesh,
                      requires_grad: bool = False):
    """Every parameter of a port model (on ``meta``) replaced in place by
    a DTensor with its policy spec's placements (a stacked path's per-layer
    tensors without the leading ``None``)."""

    specs = sh.param_pspecs(params, policy)
    new = {}
    for ps, leaf in _layer_leaves(params).items():
        spec = specs[ps]
        for t, s in ([(t, spec[1:]) for t in leaf] if isinstance(leaf, list)
                     else [(leaf, spec)]):
            new[id(t)] = nn.Parameter(_distribute(t, s, mesh),
                                      requires_grad=requires_grad)
    for mod in params.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and id(p) in new:
                mod._parameters[name] = new[id(p)]


def _distribute_cache(cache, cfg, mesh, long_context: bool):
    """A port cache (a list of per-layer dicts of meta tensors) with each
    tensor replaced in place by a DTensor with its `cache_pspecs`
    placements.  Returns the cache."""
    specs = sh.cache_pspecs(cache, long_context, False, cfg)
    owner = {}
    for ps, ts in _cache_leaves(cache, cfg).items():
        for t in ts:
            owner[id(t)] = specs[ps][1:]
    for c in cache:
        for name, t in c.items():
            c[name] = _distribute(t, owner[id(t)], mesh)
    return cache


def _distribute_batch(batch: dict, mesh, multi_pod: bool) -> dict:
    specs = sh.batch_pspecs(batch, multi_pod)
    return {k: _distribute(v, specs[k], mesh) for k, v in batch.items()}


@contextlib.contextmanager
def _sharded_prefill_cache(cfg, mesh):
    """Inside: the model module's `init_cache`, which `prefill` calls for
    its output cache, distributes that cache with the decode_32k rule
    (``cache_pspecs(..., long_context=False)``), the reference's output
    sharding of a prefill step."""
    mod = encdec if cfg.is_encdec else transformer
    orig = mod.init_cache

    def init_cache(*args, **kwargs):
        return _distribute_cache(orig(*args, **kwargs), cfg, mesh, False)

    mod.init_cache = init_cache
    try:
        yield
    finally:
        mod.init_cache = orig


def _grad(loss, leaves) -> tuple:
    """``torch.autograd.grad(loss, leaves)`` run by the autograd engine
    directly: ``torch.autograd.grad`` itself goes through the torch
    function modes, whose handler runs with its mode switched off, so the
    backward (and the recompute of each checkpointed layer) would run
    without `Redistributor`."""
    _BACKWARD[0] += 1
    try:
        return torch.autograd.Variable._execution_engine.run_backward(
            (loss,), (torch.ones_like(loss),), False, False, tuple(leaves),
            False)
    finally:
        _BACKWARD[0] -= 1


@dataclasses.dataclass
class Step:
    """One step to trace: `fn(*args)` and the arguments' local bytes."""
    fn: object
    args: tuple
    argument_bytes: dict
    notes: dict
    fsdp: dict                 # {id: mesh dim} of the FSDP-sharded params


def _microbatches(batch: dict, n: int) -> list[dict]:
    """The batch cut into `n` microbatches: each rank takes its local
    rows in n equal parts, so each microbatch keeps the batch's sharding
    (rank r's rows of microbatch i are the i-th part of its block)."""

    out = [dict() for _ in range(n)]
    for k, a in batch.items():
        parts = a.to_local().chunk(n)
        if len(parts) != n or parts[0].shape[0] * n != a.to_local().shape[0]:
            raise ValueError(f"{k}: {a.to_local().shape[0]} local rows do "
                             f"not split into {n} microbatches")
        for i, p in enumerate(parts):
            out[i][k] = DTensor.from_local(p, a.device_mesh, a.placements,
                                           run_check=False)
    return out


def build_step(arch: str, shape_name: str, policy: str, mesh,
               microbatch: int = 1, pad_vocab: bool = False,
               cfg=None) -> Step:
    """The step of one combination over DTensors on `mesh`.  `cfg`
    overrides ``get_config(arch)`` (a cut model)."""
    cfg = cfg or get_config(arch)
    if pad_vocab:
        cfg = dataclasses.replace(cfg, pad_vocab=True)
    shape = SHAPES[shape_name]
    model = build(cfg)
    multi_pod = "pod" in mesh.mesh_dim_names
    win = decode_window(cfg, shape)
    train = shape.kind == "train"
    params = model.abstract_params()
    _distribute_params(params, policy, mesh, requires_grad=train)
    arg = {"params": _local_bytes(list(params.parameters()))}

    if train:
        batch = _distribute_batch(input_specs(cfg, shape), mesh, multi_pod)
        arg.update(batch=_local_bytes(batch), cache=0)
        lr = 1e-3
        leaves = list(params.parameters())

        def placed(grads):
            # each gradient at its parameter's placements: a replicated
            # weight's partial sum over the batch all-reduced (an FSDP
            # shard's comes reduce-scattered from its gather's backward)
            return [_brought(g, p.placements) for p, g in zip(leaves, grads)]

        def train_step(batch):
            if microbatch > 1:
                loss, grads = 0.0, None
                for b in _microbatches(batch, microbatch):
                    lb = model.loss_fn(params, b, window=win)
                    g = [x.float() for x in placed(_grad(lb, leaves))]
                    grads = g if grads is None else [
                        a + x for a, x in zip(grads, g)]
                    loss = loss + lb.detach()
                loss = loss / microbatch
                grads = [g / microbatch for g in grads]
            else:
                loss = model.loss_fn(params, batch, window=win)
                grads = placed(_grad(loss, leaves))
            new = [(p.detach() - lr * g.float()).to(p.dtype)
                   for p, g in zip(leaves, grads)]
            return loss.detach(), new

        return Step(train_step, (batch,), arg, {}, _fsdp_params(params))

    if shape.kind == "prefill":
        batch = _distribute_batch(input_specs(cfg, shape), mesh, multi_pod)
        arg.update(batch=_local_bytes(batch), cache=0)

        def prefill_step(batch):
            with _sharded_prefill_cache(cfg, mesh):
                return model.prefill(params, batch, window=win)

        return Step(prefill_step, (batch,), arg, {}, _fsdp_params(params))

    # decode
    long_ctx = shape.seq_len * shape.global_batch >= 2 ** 19
    cache = _distribute_cache(
        model.abstract_cache(shape.global_batch, shape.seq_len, win), cfg,
        mesh, long_ctx)
    tokens = _distribute_batch(
        {"t": input_specs(cfg, shape)["tokens"]}, mesh, multi_pod)["t"]
    pos = shape.seq_len - 1            # the last slot: a full cache
    # the token batch and the int32 position of the reference's arguments
    arg.update(batch=_local_bytes(tokens) + 4, cache=_local_bytes(cache))

    def serve_step(cache, tokens):
        return model.decode_step(params, cache, tokens, pos, window=win)

    return Step(serve_step, (cache, tokens), arg,
                {"decode_attention": "gqa_decode's plain version "
                                     "(repro_torch.kernels.ref) on meta",
                 "decode_pos": pos}, _fsdp_params(params))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake default process group of `world_size` ranks (this one rank
    0) for the block, where no default group exists; a live group of
    `world_size` ranks is used as it is, one of another size refused.
    The group made here is destroyed on leaving."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"a live default process group of {dist.get_world_size()} "
                f"ranks; the dry run needs {world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fsdp_params(params) -> dict:
    """{id: mesh dim} of the DTensor parameters of `params` sharded over
    the ``data`` mesh dim (the FSDP axis of the policies)."""

    out = {}
    for p in params.parameters():
        names = p.device_mesh.mesh_dim_names
        m = names.index(sh.DATA)
        if isinstance(p.placements[m], Shard):
            out[id(p)] = m
    return out


def trace(step: Step) -> tuple[StepCounter, object, list, dict]:
    """Runs `step` once under `StepCounter`, `DispatchRoutes` and
    `Redistributor`, plain tensors replicated.  Returns (counter, output,
    redistributions, {routed op: calls})."""
    places = Places()
    routes = DispatchRoutes(places)
    with Redistributor(places, step.fsdp), implicit_replication(), \
            StepCounter() as counter, routes:
        out = step.fn(*step.args)
    return counter, out, places.report(), dict(sorted(routes.routed.items()))


def stack_counts(cfg) -> list[int]:
    """The layer count of each stack the driver can cut: a decoder's
    stages (each a pattern repeated its count of times), or the
    enc-dec's encoder and decoder."""
    if cfg.is_encdec:
        return [cfg.n_encoder_layers, cfg.n_layers]
    return [count for _, count in transformer.stages(cfg)]


def with_counts(cfg, counts):
    """`cfg` with each stack repeated `counts` times (its other fields
    kept: the widths are the config's)."""
    if cfg.is_encdec:
        out = dataclasses.replace(cfg, n_encoder_layers=counts[0],
                                  n_layers=counts[1])
    elif cfg.arch_type == "hybrid":
        out = dataclasses.replace(cfg,
                                  n_layers=cfg.ssm.attn_every_n * counts[0])
    else:            # dense, MoE, RWKV: one stage; MLA: one dense layer first
        out = dataclasses.replace(cfg, n_layers=sum(counts))
    if stack_counts(out) != list(counts):
        raise ValueError(f"{cfg.name}: cannot cut to stacks {counts}")
    return out


def _trace_record(arch, shape_name, policy, mesh, microbatch, pad_vocab,
                  cfg) -> dict:
    """The numbers of one trace, as the record keeps them."""
    t0 = time.perf_counter()
    step = build_step(arch, shape_name, policy, mesh, microbatch, pad_vocab,
                      cfg)
    counter, out, redist, routed = trace(step)
    arg = step.argument_bytes
    return {
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": collective_bytes(counter.collectives),
        "memory_analysis": {
            "argument_size_in_bytes": sum(arg.values()),
            "output_size_in_bytes": _local_bytes(out),
            "temp_size_in_bytes": counter.peak,
        },
        "argument_bytes": arg,
        "redistributions": redist,
        "routed": routed,
        "compile_seconds": time.perf_counter() - t0,
        **step.notes,
    }


def _lin(base, terms):
    """base + sum(w (t - base)) over (w, t) in `terms`, through dicts (a
    key missing from a dict counts 0)."""
    if isinstance(base, dict):
        keys = list(dict.fromkeys([*base, *(k for _, t in terms
                                            for k in t)]))
        return {k: _lin(base.get(k, 0), [(w, t.get(k, 0)) for w, t in terms])
                for k in keys}
    return base + sum(w * (t - base) for w, t in terms)


def _places(redistributions) -> dict:
    return {tuple((k, v if not isinstance(v, list) else tuple(v))
                  for k, v in r.items() if k != "count"): r["count"]
            for r in redistributions}


def _scale(traces, full: list[int]) -> dict:
    """The record at the full depth from traces at cut depths: traces[0]
    with every stack once, traces[1 + i] with the i-th stack of more than
    one layer twice.  Each number is the base plus n - 1 times each such
    stack's difference to the base, n its full count (the layers of a
    stack are alike, so each adds the same): exact for the FLOPs, bytes,
    collectives and arguments; the temp bytes at least the largest traced
    peak."""
    base = traces[0]
    weights = [c - 1 for c in full if c > 1]
    rec = dict(base)
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "memory_analysis",
                "argument_bytes", "routed"):
        rec[key] = _lin(base[key], [(w, t[key]) for w, t in
                                    zip(weights, traces[1:])])
    # a peak is linear in depth only where it grows with the layers (the
    # saved activations of a training step); where a transient sets it,
    # the extrapolation can undershoot: never below a traced peak
    mem = rec["memory_analysis"]
    mem["temp_size_in_bytes"] = max(
        mem["temp_size_in_bytes"],
        *(t["memory_analysis"]["temp_size_in_bytes"] for t in traces))
    counts = _lin(_places(base["redistributions"]),
                  [(w, _places(t["redistributions"]))
                   for w, t in zip(weights, traces[1:])])
    rec["redistributions"] = [dict(k, count=n) for k, n in counts.items()]
    rec["compile_seconds"] = sum(t["compile_seconds"] for t in traces)
    return rec


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            policy: str = "fsdp_tp", out_dir: str = "build/dryrun",
            verbose: bool = True, microbatch: int = 1,
            pad_vocab: bool = False, device: str = "cuda",
            scaled_depth: bool = False) -> dict:
    """Trace one combination and write its record (also returned).
    `device` is the mesh's device type.  With `scaled_depth` each stack is
    traced once and twice
    (`with_counts`; a stack of one layer once) and the numbers are scaled
    to the full count (`_scale`); the record's ``layers_traced`` lists
    the stack counts of each trace, ``stack_counts`` the full ones."""
    chips = 512 if multi_pod else 256
    cfg = get_config(arch)
    full = stack_counts(cfg)
    if scaled_depth:
        cuts = [[1] * len(full)] + [
            [2 if j == i else 1 for j in range(len(full))]
            for i, c in enumerate(full) if c > 1]
    else:
        cuts = [full]
    with fake_process_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        traces = [_trace_record(arch, shape_name, policy, mesh, microbatch,
                                pad_vocab, with_counts(cfg, c))
                  for c in cuts]
    body = _scale(traces, full) if scaled_depth else traces[0]
    record = {
        "arch": arch, "shape": shape_name, "policy": policy,
        "microbatch": microbatch,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        **body,
        "device_type": device,
        "layers_traced": cuts,
        "stack_counts": full,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {record['mesh']} ({policy}) "
              f"trace={record['compile_seconds']:.1f}s "
              f"layers_traced={cuts}")
        print("   memory:", record["memory_analysis"])
        print(f"   flops/dev={record['flops_per_device']:.3e} "
              f"bytes/dev={record['bytes_per_device']:.3e}")
        print("   collectives/dev:", record["collective_bytes_per_device"])
        print("   routed:", record["routed"])
        for r in record["redistributions"]:
            print("   redistributed:", r)
    os.makedirs(out_dir, exist_ok=True)
    mb = f"_mb{microbatch}" if microbatch > 1 else ""
    pv = "_padvocab" if pad_vocab else ""
    record["pad_vocab"] = pad_vocab
    fname = f"{arch}_{shape_name}_{record['mesh']}_{policy}{mb}{pv}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="fsdp_tp", choices=POLICIES)
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--pad-vocab", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    ap.add_argument("--scaled-depth", action="store_true",
                    help="trace each stack once and twice and scale to "
                         "its layer count")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all")
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = []
    for arch, shape in combos:
        try:
            run_one(arch, shape, multi_pod=args.multi_pod,
                    policy=args.policy, out_dir=args.out_dir,
                    microbatch=args.microbatch, pad_vocab=args.pad_vocab,
                    device=args.device, scaled_depth=args.scaled_depth)
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"== {arch} x {shape} FAILED: {type(e).__name__}: {e}")
            failures.append((arch, shape, str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_[0], f_[1], f_[2][:200])
        raise SystemExit(1)
    print("\nall dry runs traced OK")


if __name__ == "__main__":
    main(sys.argv[1:])
