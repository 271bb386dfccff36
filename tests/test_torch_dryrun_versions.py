"""The compile driver's counts do not depend on the installed torch.

DTensor's sharding rules differ between torch versions: an op one version
has no strategy for (torch 2.11: ``index_copy_``, ``index_add``,
``softplus``, ``flip``) goes, in another (2.13), through a fallback that
propagates placements through the op's decomposition
(``DecompShardingStrategy``), and the two choose different placements for
a partial sum.  The driver routes every such op itself and reduces partial
sums where they are made (``dryrun.DispatchRoutes``), so that:

  * no traced step of any family reaches DTensor's decomposition fallback
    (a spy on ``DecompShardingStrategy.propagate_strategy``, the
    propagator's caches cleared first, since their hits skip the
    fallback; on a torch without the class the traces still run);
  * the FLOPs and the collective bytes of each kind of five training and
    decode steps at smoke width equal figures fixed here, within 1e-3
    relative.  The figures were taken on torch 2.13 (CPU); the same file
    passes unchanged on torch 2.11 (the H100's machine), which is the
    cross-version check.
"""
import functools

import pytest
import torch
import torch.distributed as dist

from repro_torch import config as t_config
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import dryrun

# the small shapes of tests/test_torch_dryrun.py (the names the driver
# looks up)
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 32, "decode")}
FAMILIES = ["qwen3-4b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "internvl2-1b", "rwkv6-1.6b", "jamba-1.5-large-398b",
            "whisper-base"]
MOE = {"mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"}
REL = 1e-3

# (arch, shape): flops_per_device and collective_bytes_per_device of the
# smoke variant on the 256-rank mesh, fsdp_tp, mesh device type cpu
FIGURES = {
    ("qwen3-4b", "train_4k"): (538968064.0, {
        "all-gather": 851968, "all-reduce": 2660872,
        "reduce-scatter": 12288}),
    ("mixtral-8x7b", "decode_32k"): (3588096.0, {
        "all-gather": 343040, "all-reduce": 170048, "reduce-scatter": 0}),
    ("deepseek-v2-lite-16b", "train_4k"): (566755328.0, {
        "all-gather": 14200832, "all-reduce": 22976584,
        "reduce-scatter": 13568}),
    ("jamba-1.5-large-398b", "train_4k"): (598736896.0, {
        "all-gather": 15503360, "all-reduce": 22929864,
        "reduce-scatter": 69376}),
    ("rwkv6-1.6b", "train_4k"): (270270464.0, {
        "all-gather": 23870464, "all-reduce": 5955528,
        "reduce-scatter": 74752}),
}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _decomp_spy():
    """(the ops DecompShardingStrategy was asked for, undo), its caches
    cleared; (None, no-op) where the installed torch has no such class."""
    try:
        from torch.distributed.tensor._decompositions import \
            DecompShardingStrategy
    except ImportError:
        return None, lambda: None
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()
    calls = []
    # a method on 2.13 (the propagator's instance), a staticmethod taking
    # (op_schema, propagator) on 2.11
    orig = DecompShardingStrategy.__dict__["propagate_strategy"]
    static = isinstance(orig, staticmethod)
    fn = orig.__func__ if static else orig

    def spy(*args, **kwargs):
        calls.append(str(args[0 if static else 1].op))
        return fn(*args, **kwargs)

    DecompShardingStrategy.propagate_strategy = (staticmethod(spy) if static
                                                 else spy)

    def undo():
        DecompShardingStrategy.propagate_strategy = orig
    return calls, undo


@functools.cache
def _traced(arch, shape_name, tmp) -> tuple[dict, list | None]:
    """(record, ops through the decomposition fallback) of one smoke-width
    step, traced once per process."""
    saved = dict(t_config.SHAPES)
    get = dryrun.get_config
    t_config.SHAPES.update(SMALL)
    dryrun.get_config = lambda a: smoke_variant(get_config(a))
    calls, undo = _decomp_spy()
    try:
        rec = dryrun.run_one(arch, shape_name, device="cpu", out_dir=tmp,
                             verbose=False)
    finally:
        undo()
        dryrun.get_config = get
        t_config.SHAPES.clear()
        t_config.SHAPES.update(saved)
    return rec, calls


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_versions"))


@pytest.mark.parametrize("shape_name", list(SMALL))
@pytest.mark.parametrize("arch", FAMILIES)
def test_no_op_reaches_the_decomposition_fallback(arch, shape_name,
                                                  out_dir):
    rec, calls = _traced(arch, shape_name, out_dir)
    if calls is not None:
        assert calls == [], f"{torch.__version__}: {sorted(set(calls))}"
    # the MoE dispatch's index_copy_ takes the driver's route (and, in
    # training, the backward of its gather: index_add)
    routed = rec["routed"]
    if arch in MOE:
        assert routed.get("aten.index_copy_", 0) > 0, routed
        if shape_name == "train_4k":
            assert routed.get("aten.index_add", 0) > 0, routed
    assert set(routed) <= set(dryrun.ROUTED)
    assert rec["flops_per_device"] > 0


@pytest.mark.parametrize("arch,shape_name", list(FIGURES))
def test_counts_equal_the_fixed_figures(arch, shape_name, out_dir):
    rec, _ = _traced(arch, shape_name, out_dir)
    flops, coll = FIGURES[(arch, shape_name)]
    assert rec["flops_per_device"] == pytest.approx(flops, rel=REL)
    got = rec["collective_bytes_per_device"]
    for kind in dryrun._COLLECTIVES:
        assert got[kind] == pytest.approx(coll.get(kind, 0), rel=REL), (
            kind, got)


def test_routes_keep_their_rules():
    """Each routed op's rule on small DTensors: the index ops and scatter
    unshard their dim and shard the source as self, the pointwise ones
    follow the first operand, flip unshards its dims; partial sums are
    reduced first."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        meta = functools.partial(torch.empty, device="meta")
        x = dryrun._distribute(meta((64, 32)), ("data", "model"), mesh)
        idx = dryrun._distribute(meta((16,), dtype=torch.long), (None,),
                                 mesh)
        src = dryrun._distribute(meta((16, 32)), (None, None), mesh)
        ops, out = dryrun._index_rule((x, 0, idx, src), {}, False)
        assert out == [Replicate(), Shard(1)]
        assert ops == [out, [Replicate()] * 2, [Replicate(), Shard(1)]]
        with pytest.raises(ValueError, match="in-place index op"):
            dryrun._index_rule((x, 0, idx, src), {}, True)
        part = torch.distributed.tensor.DTensor.from_local(
            meta((64, 2)), mesh, [Shard(0), Partial()], run_check=False)
        ops, out = dryrun._pointwise_rule((part, part), {}, False)
        assert out == [Shard(0), Replicate()] and ops == [out, out]
        ops, out = dryrun._flip_rule((x, [1]), {}, False)
        assert out == [Shard(0), Replicate()] and ops == [out]
        ops, out = dryrun._scatter_rule((x, 1, x, x), {}, False)
        assert out == [Shard(0), Replicate()] and ops == [out] * 3
