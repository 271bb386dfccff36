"""The compile driver (``repro_torch.launch.dryrun``) on the CPU: the
production mesh over fake process groups, the per-rank counts of a small
DTensor program whose collectives and FLOPs are known, ``run_one`` on the
reference's own integration combinations at full width and on every
family's train, prefill and decode steps at smoke width, and the CLI; and
the model changes the trace needs (`_flash`'s tile list from host
positions, ``gqa_decode`` on ``meta``), which change no value.

What is held against the JAX reference: each record's per-rank argument
bytes equal the sum computed from the reference's ``PartitionSpec``s and
``eval_shape`` trees.  The FLOP, byte and collective counts are DTensor's,
not XLA's, so they are held to bounds only: one rank's FLOPs at least the
model's (2 N tokens for inference, 6 N tokens for training, N the active
parameters less the embedding table) over the ranks.

No fake process group outlives its test (``dryrun.fake_process_group``
destroys what it makes), so the mesh tests in the same worker see none.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.config import ShapeConfig as RefShapeConfig
from repro.configs import decode_window as ref_decode_window
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.model_zoo import build as ref_build
from repro.sharding import policy as ref_sh

from repro_torch import config as t_config
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, input_specs, smoke_variant
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention
from repro_torch.models.model_zoo import build
from repro_torch.sharding import policy as sh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"arch", "shape", "policy", "microbatch", "mesh", "chips",
               "flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "compile_seconds",
               "memory_analysis", "pad_vocab"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute"}
# small shapes for the smoke-width steps (the names the driver looks up)
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 32, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_fake_groups(multi_pod):
    n = 512 if multi_pod else 256
    with dryrun.fake_process_group(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.size() == n
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        with pytest.raises(ValueError, match="256 single-pod, 512 multi"):
            make_production_mesh(multi_pod=not multi_pod, device_type="cpu")


def test_production_mesh_refuses_other_groups():
    with pytest.raises(ValueError, match="got none"):
        make_production_mesh(device_type="cpu")
    with dryrun.fake_process_group(8):
        with pytest.raises(ValueError, match="256 single-pod, 512 multi"):
            make_production_mesh(device_type="cpu")
        # the driver refuses a live group of another size
        with pytest.raises(ValueError, match="8 ranks"):
            with dryrun.fake_process_group(256):
                pass
        assert dist.get_world_size() == 8


# ------------------------------------------------------------------ counts
def test_collective_bytes_of_known_collectives():
    """The counterpart of the reference's test_collective_parser: an
    all-gather, an all-reduce and a reduce-scatter of known sizes, by
    their result bytes on this rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        x = dryrun._distribute(torch.empty((4096, 512), device="meta"),
                               ("data", None), mesh)
        p = DTensor.from_local(torch.empty((64, 32), device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)
        with dryrun.StepCounter() as c:
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Shard(0)])
    assert dryrun.collective_bytes(c.collectives) == {
        "all-gather": 4096 * 512 * 4, "all-reduce": 64 * 32 * 4,
        "reduce-scatter": 4 * 32 * 4, "all-to-all": 0,
        "collective-permute": 0}
    # the records' own form: waits move nothing, an unknown op raises
    assert dryrun.collective_bytes([
        ("_c10d_functional.all_to_all_single", 40),
        ("_c10d_functional.wait_tensor", 99),
        ("_dtensor.shard_dim_alltoall", 2)])["all-to-all"] == 42
    with pytest.raises(ValueError, match="no HLO name"):
        dryrun.collective_bytes([("c10d.broadcast_", 8)])


def test_flops_are_one_ranks():
    """A replicated product counts in full on every rank; a Shard(0) x
    replicated one counts the rank's 1/16 of the rows."""
    from torch.distributed.tensor import Replicate

    with dryrun.fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        a = torch.empty((64, 128), device="meta")
        b = torch.empty((128, 32), device="meta")
        full = 2 * 64 * 128 * 32
        for spec, want in [((None, None), full), (("data", None),
                                                  full // 16)]:
            da = dryrun._distribute(a, spec, mesh)
            db = dryrun._distribute(b, (None, None), mesh)
            with dryrun.StepCounter() as c:
                out = da @ db
            assert c.flops == want, spec
            assert out.placements[1] == Replicate()
            assert c.bytes == (a.numel() // (full // want) + b.numel()
                               + 64 * 32 // (full // want)) * 4


# ------------------------------------------------------------------ run_one
def _local(shape, spec) -> int:
    n = int(np.prod(shape))
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            n //= ref_sh.AXIS_SIZE[a]
    return n


def _spec_bytes(tree, specs) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_local(leaf.shape, tuple(s)) * np.dtype(leaf.dtype).itemsize
               for leaf, s in zip(leaves, spec_leaves))


def _reference_arguments(rcfg, shape, policy, multi_pod) -> dict:
    """One device's argument bytes of the reference's step, from its
    PartitionSpecs and eval_shape trees."""
    model = ref_build(rcfg)
    params = model.abstract_params()
    out = {"params": _spec_bytes(params, ref_sh.param_pspecs(params,
                                                             policy))}
    if shape.kind == "decode":
        win = ref_decode_window(rcfg, shape)
        long_ctx = shape.seq_len * shape.global_batch >= 2 ** 19
        cache = model.abstract_cache(shape.global_batch, shape.seq_len, win)
        tok = {"t": ref_input_specs(rcfg, shape)["tokens"]}
        out["cache"] = _spec_bytes(cache, ref_sh.cache_pspecs(
            cache, long_ctx, multi_pod))
        out["batch"] = _spec_bytes(tok, ref_sh.batch_pspecs(
            tok, multi_pod)) + 4                     # + the int32 position
    else:
        batch = ref_input_specs(rcfg, shape)
        out["batch"] = _spec_bytes(batch, ref_sh.batch_pspecs(batch,
                                                              multi_pod))
        out["cache"] = 0
    return out


def _active_params(rcfg, kind) -> int:
    """N: the parameters a step's tokens run through, less the embedding
    table (a decode step of the enc-dec model: its decoder, without the
    cross-attention's K/V projections, and its head; an MoE layer: its
    top-k and shared experts)."""
    flat = {ref_sh._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(
                ref_build(rcfg).abstract_params())}
    n = 0
    for key, leaf in flat.items():
        size = int(np.prod(leaf.shape))
        if key == "embed":
            continue
        if rcfg.is_encdec and kind == "decode" and (
                key.startswith("enc") or key in ("dec/cross/wk",
                                                 "dec/cross/wv")):
            continue
        if "/moe/" in key and key.rsplit("/", 1)[1] in ("w1", "w2", "w3"):
            size = size // rcfg.moe.num_experts * rcfg.moe.top_k
        n += size
    return n


def _check_record(rec, arch, shape_name, rcfg, shape, multi_pod,
                  policy="fsdp_tp"):
    assert RECORD_KEYS <= set(rec)
    assert rec["arch"] == arch and rec["shape"] == shape_name
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert set(rec["collective_bytes_per_device"]) == COLLECTIVE_KEYS
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    want = _reference_arguments(rcfg, shape, policy, multi_pod)
    assert rec["argument_bytes"] == want
    # the per-tensor local shards (chip_smoke.py allocates them)
    shards = sh.param_shards(build(dryrun.get_config(rec["arch"]))
                             .abstract_params(), policy)
    assert sum(int(np.prod(shape)) * dt.itemsize
               for _, shape, dt in shards) == want["params"]
    assert mem["argument_size_in_bytes"] == sum(want.values())
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    per_token = 6 if shape.kind == "train" else 2
    bound = per_token * _active_params(rcfg, shape.kind) * tokens \
        / rec["chips"]
    assert rec["flops_per_device"] >= bound, (rec["flops_per_device"],
                                              bound)
    assert rec["bytes_per_device"] > 0


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("whisper-base", "decode_32k", False),
    ("rwkv6-1.6b", "long_500k", True),
])
def test_run_one_reference_combinations(arch, shape_name, multi_pod,
                                        tmp_path):
    """The reference's own integration combinations, at full width and
    depth."""
    rec = dryrun.run_one(arch, shape_name, multi_pod=multi_pod,
                         device="cpu", out_dir=str(tmp_path), verbose=False)
    _check_record(rec, arch, shape_name, ref_get_config(arch),
                  t_config.SHAPES[shape_name], multi_pod)
    assert rec["decode_attention"].startswith("gqa_decode's plain")
    files = os.listdir(tmp_path)
    assert files == [f"{arch}_{shape_name}_{rec['mesh']}_fsdp_tp.json"]
    assert json.load(open(tmp_path / files[0])) == json.loads(
        json.dumps(rec))


@pytest.fixture
def small_shapes(monkeypatch):
    """The port's SHAPES entries cut to SMALL and its get_config to the
    smoke variants; returns the reference's ShapeConfigs of SMALL."""
    for name, shape in SMALL.items():
        monkeypatch.setitem(t_config.SHAPES, name, shape)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: smoke_variant(get_config(arch)))
    return {name: RefShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
            for name, s in SMALL.items()}


FAMILIES = ["qwen3-4b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "internvl2-1b", "rwkv6-1.6b", "jamba-1.5-large-398b",
            "whisper-base"]


@pytest.mark.parametrize("shape_name", list(SMALL))
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_at_smoke_width(arch, shape_name, small_shapes,
                                            tmp_path):
    """Train, prefill and decode of every family, on the 256-rank mesh,
    at smoke width through a small shape; the argument bytes against the
    reference's specs of the same smoke config."""
    rec = dryrun.run_one(arch, shape_name, device="cpu",
                         out_dir=str(tmp_path), verbose=False)
    rcfg = ref_smoke_variant(ref_get_config(arch))
    _check_record(rec, arch, shape_name, rcfg, small_shapes[shape_name],
                  False)


def test_microbatch_and_scaled_depth(small_shapes, monkeypatch, tmp_path):
    """Gradient accumulation over 2 microbatches counts the same products
    as one batch; tracing each stack once and twice and scaling to its
    count gives the full trace's FLOPs, collectives and arguments."""
    arch = "qwen3-4b"
    monkeypatch.setattr(dryrun, "get_config", lambda a: dryrun.with_counts(
        smoke_variant(get_config(a)), [3]))

    def run(**kw):
        return dryrun.run_one(arch, "train_4k", device="cpu",
                              out_dir=str(tmp_path), verbose=False, **kw)

    one, two, scaled = run(), run(microbatch=2), run(scaled_depth=True)
    assert two["microbatch"] == 2
    assert two["flops_per_device"] == pytest.approx(one["flops_per_device"],
                                                    rel=0.02)
    assert os.path.exists(tmp_path / f"{arch}_train_4k_16x16_fsdp_tp_mb2"
                                      ".json")
    assert one["layers_traced"] == [[3]]
    assert scaled["layers_traced"] == [[1], [2]]
    assert scaled["stack_counts"] == [3]
    assert scaled["flops_per_device"] == one["flops_per_device"]
    assert scaled["collective_bytes_per_device"] \
        == one["collective_bytes_per_device"]
    assert scaled["argument_bytes"] == one["argument_bytes"]


@pytest.mark.parametrize("arch,counts", [
    ("qwen3-4b", [36]), ("deepseek-v2-lite-16b", [1, 26]),
    ("jamba-1.5-large-398b", [9]), ("whisper-base", [6, 6])])
def test_stack_counts_and_cuts(arch, counts):
    cfg = get_config(arch)
    assert dryrun.stack_counts(cfg) == counts
    cut = dryrun.with_counts(cfg, [min(c, 2) for c in counts])
    assert dryrun.stack_counts(cut) == [min(c, 2) for c in counts]
    assert cut.d_model == cfg.d_model


def test_cli_writes_one_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--device", "cpu",
         "--out-dir", str(tmp_path)], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "all dry runs traced OK" in res.stdout
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files == ["whisper-base_decode_32k_16x16_fsdp_tp.json"]
    rec = json.load(open(tmp_path / files[0]))
    assert RECORD_KEYS <= set(rec) and rec["chips"] == 256


# ------------------------------------------------------------------ model
def test_on_cuda_routes_by_device():
    """CPU inputs take the plain path; meta inputs too where the wrapper
    lets them (gqa_decode); CUDA inputs the kernel; any other device
    raises."""
    def dev(kind, dtype=torch.float32):
        return types.SimpleNamespace(device=torch.device(kind), dtype=dtype,
                                     is_contiguous=lambda: True)

    assert ops._on_cuda("k", dev("cpu"), dev("cpu")) is False
    assert ops._on_cuda("k", dev("meta"), meta=True) is False
    assert ops._on_cuda("k", dev("cuda")) is True
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops._on_cuda("k", dev("meta"))
    for kind in ("xpu", "mps"):
        with pytest.raises(ValueError, match=f"no kernel for device {kind}"):
            ops._on_cuda("k", dev(kind), meta=True)
    with pytest.raises(ValueError, match="several devices"):
        ops._on_cuda("k", dev("cpu"), dev("meta"), meta=True)
    with pytest.raises(TypeError, match="kernel takes"):
        ops._on_cuda("k", dev("cuda", torch.bfloat16))


def test_gqa_decode_on_meta_takes_the_plain_version():
    ops.reset_launch_counts()
    q = torch.empty((2, 8, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((2, 100, 2, 64), device="meta", dtype=torch.bfloat16)
    v = torch.empty((2, 100, 2, 32), device="meta", dtype=torch.bfloat16)
    pos = torch.empty((100,), device="meta", dtype=torch.int32)
    out = ops.gqa_decode(q, k, v, pos, 99, 16)
    assert out.is_meta and tuple(out.shape) == (2, 8, 32)
    assert out.dtype == torch.bfloat16
    assert ops.LAUNCHES["gqa_decode"] == 0


def _tile_pairs_on_device(q_pos, k_pos, window, chunk):
    """The tile list as `_flash` read it back from the device before."""
    S, T = q_pos.shape[0], k_pos.shape[0]
    valid = (k_pos[None, :] >= 0).expand(S, T) \
        & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    n_q, n_k = -(-S // chunk), -(-T // chunk)
    tiles = torch.zeros((n_q * chunk, n_k * chunk), dtype=torch.bool)
    tiles[:S, :T] = valid
    return tiles.reshape(n_q, chunk, n_k, chunk).any(3).any(1).numpy()


def test_tile_pairs_on_the_host_equal_the_device_read():
    rng = np.random.default_rng(0)
    for trial in range(200):
        S, T = (int(x) for x in rng.integers(1, 160, 2))
        chunk = int(rng.choice([4, 16, 32, 64]))
        window = int(rng.choice([0, 1, 5, 30, 100]))
        if trial % 3 == 0:
            q_pos, k_pos = np.arange(S), np.arange(T)
        else:
            q_pos = rng.integers(-3, 200, S)
            k_pos = rng.integers(-3, 200, T)
        want = _tile_pairs_on_device(torch.from_numpy(q_pos),
                                     torch.from_numpy(k_pos), window, chunk)
        assert np.array_equal(attention.tile_pairs(q_pos, k_pos, window,
                                                   chunk), want)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_with_host_positions_is_bit_identical(window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 70, 4, 16), generator=g)
    k = torch.randn((2, 70, 2, 16), generator=g)
    v = torch.randn((2, 70, 2, 8), generator=g)
    pos = np.arange(70, dtype=np.int32)
    tp = torch.from_numpy(pos)
    want = attention._flash(q, k, v, tp, tp, window, chunk=16)
    got = attention._flash(q, k, v, tp, tp, window, chunk=16,
                           host_pos=(pos, pos))
    assert torch.equal(got, want)
    # under autograd: the same gradient bits
    qg = q.clone().requires_grad_(True)
    attention._flash(qg, k, v, tp, tp, window, chunk=16).sum().backward()
    qh = q.clone().requires_grad_(True)
    attention._flash(qh, k, v, tp, tp, window, chunk=16,
                     host_pos=(pos, pos)).sum().backward()
    assert torch.equal(qg.grad, qh.grad)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b",
                                  "whisper-base"])
def test_steps_trace_on_meta_without_dtensor(arch):
    """Each attention family's prefill, decode step and loss backward run
    on plain meta tensors (no host read of a value)."""
    cfg = smoke_variant(get_config(arch))
    model = build(cfg)
    params = model.abstract_params()
    for p in params.parameters():
        p.requires_grad_(True)
    batch = input_specs(cfg, SMALL["train_4k"])
    loss = model.loss_fn(params, batch)
    loss.backward()
    assert loss.is_meta and params.embed.grad.is_meta
    pre = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(params, pre, cache_len=80)
    assert logits.is_meta and tuple(logits.shape) == (32, cfg.vocab_padded
                                                      if not cfg.is_encdec
                                                      else cfg.vocab)
    logits, _ = model.decode_step(params, cache,
                                  torch.empty((32, 1), dtype=torch.int32,
                                              device="meta"), 64)
    assert logits.is_meta
