"""The compile driver under the reference's four other sharding policies
(``tp_only``, ``dp_only``, ``fsdp_tp_ep``, ``tp_only_ep``): the MoE
families and a dense one, a decode and a training step each, at smoke
width on the 256-rank mesh.  Each record's per-rank argument bytes equal
the reference's ``PartitionSpec``s under the same policy (the same check
as ``tests/test_torch_dryrun.py``'s for ``fsdp_tp``), and no op reaches
DTensor's decomposition fallback.
"""
import pytest
import torch.distributed as dist
from test_torch_dryrun import SMALL, _check_record
from test_torch_dryrun_versions import _decomp_spy

from repro.config import ShapeConfig as RefShapeConfig
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant

from repro_torch import config as t_config
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import dryrun

POLICIES = ["tp_only", "dp_only", "fsdp_tp_ep", "tp_only_ep"]


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "qwen3-4b"])
@pytest.mark.parametrize("policy", POLICIES)
def test_other_policies_trace_at_smoke_width(policy, arch, shape_name,
                                             monkeypatch, tmp_path):
    for name, shape in SMALL.items():
        monkeypatch.setitem(t_config.SHAPES, name, shape)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: smoke_variant(get_config(a)))
    calls, undo = _decomp_spy()
    try:
        rec = dryrun.run_one(arch, shape_name, policy=policy, device="cpu",
                             out_dir=str(tmp_path), verbose=False)
    finally:
        undo()
    assert not calls, calls
    assert rec["policy"] == policy
    s = SMALL[shape_name]
    _check_record(rec, arch, shape_name,
                  ref_smoke_variant(ref_get_config(arch)),
                  RefShapeConfig(s.name, s.seq_len, s.global_batch, s.kind),
                  False, policy=policy)
