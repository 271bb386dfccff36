"""The figures that ``chip_smoke.py``'s ``dryrun`` phase holds the card's
records to (``DRYRUN_FIGURES``): each combination of ``DRYRUN_RUNS``
traced at full width as the phase traces it (the mesh on the cuda device
type, which decides how DTensor moves a shard from one dim to another),
its FLOPs and each kind of collective bytes within ``DRYRUN_REL``.  This
holds them on the installed torch; the phase holds the card's records,
taken on another torch version, to the same figures.
"""
import os
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_every_run_has_its_figures():
    assert {(a, s) for a, s, _ in chip_smoke.DRYRUN_RUNS} \
        == set(chip_smoke.DRYRUN_FIGURES)
    assert len(chip_smoke.DRYRUN_RUNS) == 6


@pytest.mark.parametrize("arch,shape,extra", chip_smoke.DRYRUN_RUNS)
def test_full_width_records_equal_the_figures(arch, shape, extra, tmp_path):
    rec = dryrun.run_one(arch, shape, multi_pod="--multi-pod" in extra,
                         scaled_depth="--scaled-depth" in extra,
                         device="cuda", out_dir=str(tmp_path), verbose=False)
    flops, coll = chip_smoke.DRYRUN_FIGURES[(arch, shape)]
    rel = chip_smoke.DRYRUN_REL
    assert rec["flops_per_device"] == pytest.approx(flops, rel=rel)
    got = rec["collective_bytes_per_device"]
    for kind in got:
        assert got[kind] == pytest.approx(coll.get(kind, 0), rel=rel), (
            kind, got)
