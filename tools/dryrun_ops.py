"""The compile driver's traces op by op: which DTensor ops reach a
DTensor mechanism that only some torch versions have, and where each
rank's FLOPs, bytes and collective bytes come from.  Host work only; on
the CPU or on a machine with a card alike (the mesh's device type is
``--device``, cpu by default):

    PYTHONPATH=src python tools/dryrun_ops.py survey --out survey.json
    PYTHONPATH=src python tools/dryrun_ops.py ops --arch qwen3-4b \
        --shape train_4k --layers 1 --out ops.json
    PYTHONPATH=src python tools/dryrun_ops.py names --arch mixtral-8x7b \
        --shape decode_32k --device cuda --out names.json

``survey`` traces every family's train, prefill and decode steps at
smoke width (the small shapes of ``tests/test_torch_dryrun.py``) and
lists, for each, the ops that went through DTensor's decomposition
fallback (``DecompShardingStrategy``, where the installed torch has it)
and the ops that raised for want of a sharding strategy.  Such an op is
then run on replicated operands so that the trace goes on (its counts are
marked ``rescued``), so one run lists every such op.  ``ops`` traces one
combination at published width, cut to `--layers` layers a stack (a
stack of one layer kept whole; ``--smoke``: the smoke variant and the
small shape).  Both write, for each trace, the record's counts and the
counts of each DTensor op by (source line, op, operand placements):
FLOPs, bytes, collective bytes by kind, and the live bytes at the peak
by the op that made them (``--source-tags``: by source line only, with
no mode of the tool's own in the trace).  ``names`` runs the driver's own
trace (``run_one``, its record unchanged) with the bytes summed by local
op name.  Diff two ``survey`` or ``ops`` files (two torch versions) with
``diff``:

    python tools/dryrun_ops.py diff a.json b.json [--bytes]
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback
import weakref

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import config as t_config  # noqa: E402
from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

SMALL = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 32, "decode")}
FAMILIES = ["qwen3-4b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "internvl2-1b", "rwkv6-1.6b", "jamba-1.5-large-398b",
            "whisper-base"]
_NO_STRATEGY = "does not have a sharding strategy registered"


def _placements(args) -> str:
    return ",".join("".join(str(p) for p in t.placements)
                    for t in dryrun._tensors(args) if isinstance(t, DTensor))


class OpTags(TorchDispatchMode):
    """The outermost mode of a trace: names the DTensor op that runs now
    (`tag`) for `ByOp`, and runs an op that raises for want of a sharding
    strategy on replicated operands (each such op in `rescued`)."""

    def __init__(self):
        super().__init__()
        self.tag = None
        self.rescued: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = f"{func.namespace}.{func._overloadpacket.__name__}"
        outer = self.tag
        self.tag = f"{dryrun._where()}|{name}|{_placements((args, kwargs))}"
        try:
            return func(*args, **kwargs)
        except NotImplementedError as e:
            if _NO_STRATEGY not in str(e):
                raise
            self.rescued[name] = self.rescued.get(name, 0) + 1
            return _replicated_run(func, args, kwargs)
        finally:
            self.tag = outer


def _replicated_run(func, args, kwargs):
    """`func` on the local tensors of its operands replicated, its results
    wrapped as replicated DTensors (outside autograd, as the driver's
    routes run)."""
    mesh = next(t.device_mesh for t in dryrun._tensors((args, kwargs))
                if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim

    def local(a):
        if isinstance(a, DTensor):
            return dryrun._moved(a, rep)._local_tensor
        if isinstance(a, (list, tuple)):
            return type(a)(local(x) for x in a)
        return a

    out = func(*local(args), **{k: local(v) for k, v in kwargs.items()})
    if isinstance(out, torch.Tensor):
        return dryrun._as_dtensor(out, mesh)
    return type(out)(dryrun._as_dtensor(o, mesh) for o in out)


class SourceTags:
    """In place of `OpTags` where no mode may be added to the trace: the
    model's source line that runs now, read from the stack."""

    rescued: dict = {}

    @property
    def tag(self):
        return dryrun._where()


class ByOp(dryrun.StepCounter):
    """`StepCounter` that also sums each count by `tags`' DTensor op, and
    keeps the live bytes by the op that made them at the peak
    (`peak_by`)."""

    def __init__(self, tags):
        super().__init__()
        self.tags = tags
        self.by_op: dict = {}
        self.live_by: dict = {}
        self.peak_by: dict = {}

    def _track(self, out):
        tag = self.tags.tag or "-"
        for t in dryrun._tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages.add(key)
            nbytes = st.nbytes()
            self.live += nbytes
            self.live_by[tag] = self.live_by.get(tag, 0) + nbytes
            weakref.finalize(st, self._free_by, key, nbytes, tag)
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = {k: v for k, v in self.live_by.items() if v}

    def _free_by(self, key, nbytes, tag):
        self._free(key, nbytes)
        self.live_by[tag] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = (self.flops, self.bytes, len(self.collectives))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        row = self.by_op.setdefault(self.tags.tag or "-", {
            "flops": 0, "bytes": 0, "n": 0, **{
                k: 0 for k in dryrun._COLLECTIVES}})
        row["flops"] += self.flops - before[0]
        row["bytes"] += self.bytes - before[1]
        row["n"] += 1
        for k, v in dryrun.collective_bytes(
                self.collectives[before[2]:]).items():
            row[k] += v
        return out


def _decomp_spy():
    """(calls list, undo) of a spy on DecompShardingStrategy's
    propagate_strategy, with the propagator's cache cleared; (None, no-op)
    on a torch without that class."""
    try:
        from torch.distributed.tensor._decompositions import \
            DecompShardingStrategy
    except ImportError:
        return None, lambda: None
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()
    calls = []
    # a method on 2.13, a staticmethod (op_schema, propagator) on 2.11
    orig = DecompShardingStrategy.__dict__["propagate_strategy"]
    static = isinstance(orig, staticmethod)
    fn = orig.__func__ if static else orig

    def spy(*a, **k):
        calls.append(str(a[0 if static else 1].op))
        return fn(*a, **k)

    DecompShardingStrategy.propagate_strategy = (staticmethod(spy) if static
                                                 else spy)

    def undo():
        DecompShardingStrategy.propagate_strategy = orig
    return calls, undo


def trace_one(arch, shape_name, cfg, device, policy="fsdp_tp",
              source_tags=False) -> dict:
    t0 = time.perf_counter()
    calls, undo = _decomp_spy()
    out = {"arch": arch, "shape": shape_name, "policy": policy}
    try:
        with dryrun.fake_process_group(256):
            mesh = make_production_mesh(device_type=device)
            step = dryrun.build_step(arch, shape_name, policy, mesh, cfg=cfg)
            places = dryrun.Places()
            tags = SourceTags() if source_tags else OpTags()
            counter = ByOp(tags)
            routes = dryrun.DispatchRoutes(places)
            with contextlib.ExitStack() as stack:
                for mode in (dryrun.Redistributor(places, step.fsdp),
                             implicit_replication(), counter, routes,
                             *(() if source_tags else (tags,))):
                    stack.enter_context(mode)
                step.fn(*step.args)
        out.update(
            flops=float(counter.flops), bytes=float(counter.bytes),
            collectives=dryrun.collective_bytes(counter.collectives),
            temp=counter.peak, rescued=tags.rescued, routed=routes.routed,
            redistributions=places.report(), by_op=counter.by_op,
            peak_by=counter.peak_by)
    except Exception as e:  # noqa: BLE001 - report and go on
        out["error"] = f"{type(e).__name__}: {e}"[:2000]
        out["traceback"] = traceback.format_exc()[-4000:]
    finally:
        undo()
    out["decomp_calls"] = sorted(set(calls)) if calls is not None else None
    out["seconds"] = time.perf_counter() - t0
    return out


def survey(device):
    for name, shape in SMALL.items():
        t_config.SHAPES[name] = shape
    for arch in FAMILIES:
        cfg = smoke_variant(get_config(arch))
        for shape_name in SMALL:
            rec = trace_one(arch, shape_name, cfg, device)
            print(json.dumps({k: rec.get(k) for k in (
                "arch", "shape", "flops", "collectives", "rescued",
                "decomp_calls", "error", "seconds")}), flush=True)
            yield rec


class ByName(dryrun.StepCounter):
    """`StepCounter` that also sums the bytes by local op name, and
    nothing else: the driver's own trace, its record unchanged."""

    def __init__(self):
        super().__init__()
        self.by_name: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and self.bytes != before:
            name = f"{func.namespace}.{func._overloadpacket.__name__}"
            self.by_name[name] = self.by_name.get(name, 0) \
                + self.bytes - before
        return out


def names(arch, shape_name, scaled_depth, device) -> dict:
    """`dryrun.run_one`'s record, with the bytes of each trace by local
    op name (`ByName` in place of the driver's counter)."""
    traces = []
    counter, trace = dryrun.StepCounter, dryrun.trace

    def by_name_trace(step):
        out = trace(step)
        traces.append(out[0].by_name)
        return out

    dryrun.StepCounter, dryrun.trace = ByName, by_name_trace
    try:
        rec = dryrun.run_one(arch, shape_name, scaled_depth=scaled_depth,
                             device=device, out_dir=tempfile.mkdtemp(),
                             verbose=False)
    finally:
        dryrun.StepCounter, dryrun.trace = counter, trace
    return {"arch": arch, "shape": shape_name, "torch": torch.__version__,
            "bytes": rec["bytes_per_device"], "by_name": traces}


def diff(a_path, b_path, top=40, with_bytes=False):
    a = {(r["arch"], r["shape"], r.get("layers")): r
         for r in json.load(open(a_path))}
    b = {(r["arch"], r["shape"], r.get("layers")): r
         for r in json.load(open(b_path))}
    keys = ("flops", "bytes", *dryrun._COLLECTIVES)
    for k in a.keys() & b.keys():
        ra, rb = a[k], b[k]
        if "by_op" not in ra or "by_op" not in rb:
            print(k, "error:", ra.get("error"), rb.get("error"))
            continue
        print("==", k, {c: (ra["collectives"][c], rb["collectives"][c])
                        for c in dryrun._COLLECTIVES}, ra["flops"],
              rb["flops"], "bytes", ra["bytes"], rb["bytes"], "temp",
              ra["temp"], rb["temp"])
        rows = []
        for tag in ra["by_op"].keys() | rb["by_op"].keys():
            x = ra["by_op"].get(tag, {})
            y = rb["by_op"].get(tag, {})
            d = {c: y.get(c, 0) - x.get(c, 0) for c in keys}
            if any(d[c] for c in keys if with_bytes or c != "bytes"):
                rows.append((max(abs(v) for c, v in d.items()
                                 if with_bytes or c != "bytes"), tag, d))
        for _, tag, d in sorted(rows, reverse=True)[:top]:
            print("  ", tag, {c: v for c, v in d.items() if v})
        if with_bytes and ra["temp"] != rb["temp"]:
            pa, pb = ra.get("peak_by", {}), rb.get("peak_by", {})
            live = sorted(((pb.get(t, 0) - pa.get(t, 0), t)
                           for t in pa.keys() | pb.keys()),
                          key=lambda x: -abs(x[0]))
            for v, t in live[:top // 4]:
                if v:
                    print("   live at the peak:", t, v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["survey", "ops", "names", "diff"])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--layers", type=int, nargs="*", default=[1])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--policy", default="fsdp_tp")
    ap.add_argument("--out")
    ap.add_argument("--bytes", action="store_true",
                    help="diff: list the ops whose bytes differ too")
    ap.add_argument("--scaled-depth", action="store_true",
                    help="names: as the driver's --scaled-depth")
    ap.add_argument("--source-tags", action="store_true",
                    help="ops: tag by the model's source line only, with "
                         "no mode added to the driver's")
    args = ap.parse_args(argv)
    if args.mode == "diff":
        diff(*args.files, with_bytes=args.bytes)
        return
    if args.mode == "names":
        rec = names(args.arch, args.shape, args.scaled_depth, args.device)
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "bytes")}))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f)
        return
    if args.mode == "survey":
        recs = list(survey(args.device))
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
            t_config.SHAPES[args.shape] = SMALL[args.shape]
        recs = []
        for n in args.layers:
            rec = trace_one(args.arch, args.shape, dryrun.with_counts(
                cfg, [min(n, c) for c in dryrun.stack_counts(cfg)]),
                args.device,
                args.policy, args.source_tags)
            rec["layers"] = n
            print(json.dumps({k: rec.get(k) for k in (
                "arch", "shape", "layers", "flops", "collectives",
                "rescued", "decomp_calls", "error", "seconds")}), flush=True)
            recs.append(rec)
    meta = {"torch": torch.__version__}
    for r in recs:
        r.update(meta)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f)


if __name__ == "__main__":
    main(sys.argv[1:])
