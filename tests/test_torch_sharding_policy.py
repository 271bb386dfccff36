"""The compile driver's sharding policies, input specs and abstract caches
(``repro_torch.sharding.policy``, ``repro_torch.configs.input_specs``,
``Model.abstract_cache``, ``carry.cache_layout``) against the JAX
reference on the CPU, every architecture at its full config.

Exact equality throughout: the spec of every param leaf under each of the
five policies equal to ``repro.sharding.policy.param_pspecs``' under the
same key path, the batch specs, the cache specs (decode_32k's 128 x 32768
and long_500k's 1 x 524288 caches, long context on and off, one pod and
two), the input specs' and abstract caches' shapes and dtypes equal to the
reference's ``ShapeDtypeStruct``s; the reference's divisibility properties
(``tests/test_sharding_policy.py``) hold for the port's specs; and
`placements` lays rank r's local block out as the reference's
``PartitionSpec`` lays out device r's.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.config import SHAPES as REF_SHAPES
from repro.configs import decode_window as ref_decode_window
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.models.model_zoo import build as ref_build
from repro.sharding import policy as ref_sh

from repro_torch import carry
from repro_torch.config import SHAPES, MeshConfig
from repro_torch.configs import ARCH_IDS, decode_window, get_config, input_specs
from repro_torch.models.model_zoo import build
from repro_torch.sharding import policy as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ["fsdp_tp", "tp_only", "dp_only", "fsdp_tp_ep", "tp_only_ep"]
DECODE_SHAPES = ["decode_32k", "long_500k"]


def _ref_specs(tree) -> dict:
    """{key path: spec as a tuple} of a reference PartitionSpec tree."""
    return {ref_sh._path_str(path): tuple(spec) for path, spec in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_build(ref_get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _params(arch):
    return build(get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    """(reference abstract cache, port abstract cache) of a decode shape
    at decode_window's window."""
    shape = SHAPES[shape_name]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    win = decode_window(cfg, shape)
    assert win == ref_decode_window(rcfg, shape_name)
    ref = ref_build(rcfg).abstract_cache(shape.global_batch, shape.seq_len,
                                         win)
    return ref, build(cfg).abstract_cache(shape.global_batch, shape.seq_len,
                                          win)


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, policy):
    want = _ref_specs(ref_sh.param_pspecs(_ref_params(arch), policy))
    got = sh.param_pspecs(_params(arch), policy)
    assert got == want


def test_unknown_policy_replicates_everything():
    got = sh.param_pspecs(_params("qwen3-4b"), "no_such_policy")
    want = _ref_specs(ref_sh.param_pspecs(_ref_params("qwen3-4b"),
                                          "no_such_policy"))
    assert got == want
    assert all(ax is None for spec in got.values() for ax in spec)


# ------------------------------------------------------------------ batch
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_batch_specs_equal_reference(shape_name, multi_pod):
    for arch in ARCH_IDS:
        batch = input_specs(get_config(arch), shape_name)
        want = _ref_specs(ref_sh.batch_pspecs(
            ref_input_specs(ref_get_config(arch), shape_name), multi_pod))
        assert sh.batch_pspecs(batch, multi_pod) == want, arch
    # a batch the pod x data axes do not divide stays replicated
    odd = {"tokens": torch.empty((3, 8), device="meta")}
    assert sh.batch_pspecs(odd, True) == {"tokens": (None, None)}
    assert sh.batch_pspecs({"s": torch.empty((), device="meta")},
                           False) == {"s": ()}


# ------------------------------------------------------------------ cache
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, shape_name, long_context,
                                     multi_pod):
    ref, cache = _caches(arch, shape_name)
    want = _ref_specs(ref_sh.cache_pspecs(ref, long_context, multi_pod))
    got = sh.cache_pspecs(cache, long_context, multi_pod, get_config(arch))
    assert got == want


@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_layout_equals_eval_shape(arch, shape_name):
    ref, cache = _caches(arch, shape_name)
    want = {ref_sh._path_str(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    got = {k: (shape, _dt(dt)) for k, (shape, dt) in
           carry.cache_layout(cache, get_config(arch)).items()}
    assert got == want
    assert all(t.is_meta for c in cache for t in c.values())


# ------------------------------------------------------------------ inputs
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in ref_input_specs(rcfg, shape_name).items()}
    got = input_specs(cfg, shape_name)
    assert {k: (tuple(v.shape), _dt(v.dtype)) for k, v in got.items()} \
        == want
    assert all(v.is_meta for v in got.values())
    # a ShapeConfig and a batch override, on another device
    over = input_specs(cfg, SHAPES[shape_name], batch_override=2,
                       device="cpu")
    ref_over = ref_input_specs(rcfg, REF_SHAPES[shape_name],
                               batch_override=2)
    assert {k: tuple(v.shape) for k, v in over.items()} \
        == {k: tuple(v.shape) for k, v in ref_over.items()}
    assert all(v.device.type == "cpu" for v in over.values())


def test_mesh_config_equals_reference():
    from repro.config import MeshConfig as RefMeshConfig
    for mp in (False, True):
        assert MeshConfig(mp).shape == RefMeshConfig(mp).shape
        assert MeshConfig(mp).axes == RefMeshConfig(mp).axes


# ------------------------------------------------------------------ the
# reference's divisibility properties (tests/test_sharding_policy.py)
def _divides(shape, spec):
    for dim, ax in zip(shape, tuple(spec) + (None,) * 8):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        assert dim % int(np.prod([sh.AXIS_SIZE[a] for a in axes])) == 0, \
            (shape, spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_cover_tree_and_divide(arch):
    params = _params(arch)
    specs = sh.param_pspecs(params, "fsdp_tp")
    layout = carry.reference_layout(params)
    assert specs.keys() == layout.keys()
    for key, (shape, _) in layout.items():
        assert len(specs[key]) <= len(shape), key
        _divides(shape, specs[key])


@pytest.mark.parametrize("long_ctx", [False, True])
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "whisper-base",
                                  "rwkv6-1.6b"])
def test_cache_specs_divide(arch, long_ctx):
    cfg = get_config(arch)
    batch, seq = (1, 524288) if long_ctx else (128, 32768)
    cache = build(cfg).abstract_cache(batch, seq, 0)
    specs = sh.cache_pspecs(cache, long_ctx, False, cfg)
    for key, (shape, _) in carry.cache_layout(cache, cfg).items():
        _divides(shape, specs[key])


def test_tp_only_removes_fsdp_axis():
    flat = [a for s in sh.param_pspecs(_params("yi-6b"), "tp_only").values()
            for a in s if a is not None]
    assert flat and all(a == "model" for a in flat)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_expert_parallel_policy(arch):
    specs = sh.param_pspecs(_params(arch), "fsdp_tp_ep")
    found = {k: s for k, s in specs.items()
             if "/moe/" in k and k.rsplit("/", 1)[1] in ("w1", "w2", "w3")}
    assert found
    assert all(s[1] == "model" for s in found.values())
    # mixtral (8 experts < 16) falls back to TP within each expert
    mx = sh.param_pspecs(_params("mixtral-8x7b"), "fsdp_tp_ep")
    w1 = [s for k, s in mx.items() if k.endswith("/moe/w1")]
    assert w1 and all(s[1] != "model" for s in w1)


def test_fsdp_tp_uses_both_axes():
    flat = [a for s in sh.param_pspecs(_params("qwen3-32b"),
                                       "fsdp_tp").values()
            for a in s if a is not None]
    assert "model" in flat and "data" in flat


# ------------------------------------------------------------------ blocks
SPECS = [(("data", "model"), None), (None, "model"), ("data", "model"),
         (("data",), None), ("model", "data"), (None, ("data", "model")),
         (None, None)]
SHAPE = (8, 16)

_REF_BLOCKS = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
specs = json.loads(sys.argv[1])
shape = tuple(json.loads(sys.argv[2]))
devs = np.array(jax.devices()[:8]).reshape(2, 4)
mesh = Mesh(devs, ("data", "model"))
out = []
for spec in specs:
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    out.append([[list(s.indices(n))[:2] for s, n in zip(idx[d], shape)]
                for d in devs.reshape(-1)])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_blocks():
    """Device r's block of each spec on a (data 2, model 4) mesh of 8
    placeholder XLA devices, device r at mesh position (r // 4, r % 4):
    per device, per dim (start, stop).  XLA's device count is fixed at
    its first use, so this runs in a process of its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _REF_BLOCKS, json.dumps(SPECS),
         json.dumps(SHAPE)], capture_output=True, text=True, env=env,
        timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_placements_lay_out_blocks_as_the_reference(ref_blocks):
    """On a fake group of 8 ranks and a (2, 4) mesh, rank r's local block
    of an arange tensor under `placements` is device r's block of the
    reference's PartitionSpec, for every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    full = torch.arange(np.prod(SHAPE)).reshape(SHAPE)
    assert not dist.is_initialized()
    for r in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        try:
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            for spec, blocks in zip(SPECS, ref_blocks):
                local = distribute_tensor(full, mesh,
                                          sh.placements(spec, mesh),
                                          src_data_rank=None).to_local()
                (a0, b0), (a1, b1) = blocks[r]
                assert torch.equal(local, full[a0:b0, a1:b1]), (r, spec)
        finally:
            dist.destroy_process_group()


def test_placements_refuse_bad_specs():
    """A tuple of axes against the mesh's order, an axis the mesh lacks or
    an axis used twice."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        for bad in [(("model", "data"), None), ("pod", None),
                    ("data", "data")]:
            with pytest.raises(ValueError):
                sh.placements(bad, mesh)
    finally:
        dist.destroy_process_group()
