"""The model zoo's other families (mixtral-8x7b, deepseek-v2-lite-16b,
internvl2-1b, whisper-base, rwkv6-1.6b, jamba-1.5-large-398b) through
the training entry points around ``loss_fn``, against the JAX reference
on the CPU: ``abstract_params`` of every ``ARCH_ID`` at its full config,
param checkpoints of each family both ways across packages, plain and
federated ``train``, the train CLI and the coded probe's features.
(``loss_fn`` and its gradients: ``tests/test_torch_train_families.py``
and ``tests/test_torch_train_recurrent.py``.)

Tolerances, as ``tests/test_torch_train.py``'s:

  * ``abstract_params``: shapes and leaf dtypes equal to the reference's
    ``eval_shape`` tree, no storage;
  * checkpoints: the same bits both ways, each leaf in its dtype
    (``transformer.FLOAT32_LEAVES`` float32 in a bf16 model);
  * ``train`` (smoke variants, float32, the reference's weights carried):
    losses within 1e-4 relative through 3 Adam steps; the federated host
    quantities (t*, the loads, the simulated wall clock, each step's
    returned clients) equal;
  * the CLI: the reference's printed lines, numbers aside, and the same
    simulated wall clock;
  * ``coded_probe.extract_features``: within 1e-5 of the largest
    feature.
"""
import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.core import coded_probe as ref_probe
from repro.launch import train as ref_train
from repro.models.model_zoo import build as ref_build

from repro_torch import carry
from repro_torch.checkpoint import io as ckpt
from repro_torch.config import FLConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import coded_probe
from repro_torch.launch import train as t_train
from repro_torch.launch.train import train
from repro_torch.models.model_zoo import build
from torch_zoo import (Family, cfgs, check_param_checkpoints,
                       reference_plan, tree_np)

FAMILIES = ("mixtral-8x7b", "deepseek-v2-lite-16b", "internvl2-1b",
            "whisper-base", "rwkv6-1.6b", "jamba-1.5-large-398b")
TRAIN_TOL = 1e-4
FEATURE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ abstract
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference_every_arch(arch):
    """Full config: shapes and leaf dtypes of the reference's eval_shape
    tree, on the meta device (no storage)."""
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            ckpt._path_leaves(ref_build(rcfg).abstract_params())}
    ghost = build(cfg).abstract_params()
    assert all(p.is_meta for p in ghost.parameters())
    got = {k: (shape, str(dt).replace("torch.", ""))
           for k, (shape, dt) in carry.reference_layout(ghost).items()}
    assert got == want


# ------------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_checkpoints_both_ways(arch, tmp_path):
    check_param_checkpoints(arch, tmp_path)


# ------------------------------------------------------------------ train
@pytest.mark.parametrize("arch,seq", [("mixtral-8x7b", 32),
                                      ("internvl2-1b", 36),
                                      ("whisper-base", 24),
                                      ("rwkv6-1.6b", 64)])
def test_train_plain_matches_reference(arch, seq):
    rcfg, cfg = cfgs(arch)
    _, want, wall = ref_train.train(rcfg, steps=3, batch=2, seq=seq,
                                    log_every=0, seed=2)
    params = carry.model_params_from_reference(
        tree_np(ref_build(rcfg).init_params(jax.random.PRNGKey(2))), cfg,
        "cpu")
    got_params, got, got_wall = train(cfg, steps=3, batch=2, seq=seq,
                                      log_every=0, seed=2, device="cpu",
                                      params=params)
    assert got_params is params and got_wall == wall == 0.0
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)


def test_train_federated_deepseek_matches_reference():
    rcfg, cfg = cfgs("deepseek-v2-lite-16b")
    steps, batch, seq, seed, n = 3, 2, 32, 0, 4
    t_star, loads, returned = reference_plan(
        rcfg, RefFLConfig(n_clients=n), batch, seq, seed, steps)
    _, want, wall = ref_train.train(rcfg, steps=steps, batch=batch, seq=seq,
                                    federated=True,
                                    fl_cfg=RefFLConfig(n_clients=n),
                                    log_every=0, seed=seed)
    params = carry.model_params_from_reference(
        tree_np(ref_build(rcfg).init_params(jax.random.PRNGKey(seed))), cfg,
        "cpu")
    hist = {}
    _, got, got_wall = train(cfg, steps=steps, batch=batch, seq=seq,
                             federated=True, fl_cfg=FLConfig(n_clients=n),
                             log_every=0, seed=seed, device="cpu",
                             params=params, history=hist)
    assert got_wall == wall == steps * t_star
    assert hist["t_star"] == t_star and hist["loads"] == loads
    assert hist["returned"] == returned
    assert any(len(r) for r in returned)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)


# ------------------------------------------------------------------ CLI
def _run_printed(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


_NUM = re.compile(r"-?\d+(\.\d+)?")


def test_train_main_prints_the_references_lines_rwkv6(monkeypatch):
    argv = ["--arch", "rwkv6-1.6b", "--steps", "2", "--batch", "2",
            "--seq", "64", "--federated"]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    want = _run_printed(ref_train.main)
    got = _run_printed(lambda: t_train.main(argv + ["--device", "cpu"]))
    assert [_NUM.sub("#", ln) for ln in got] == \
        [_NUM.sub("#", ln) for ln in want]
    sim = re.compile(r"wall-clock ([\d.]+)s")
    assert sim.search(got[-1]).group(1) == sim.search(want[-1]).group(1)


# ------------------------------------------------------------------ probe
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b"])
def test_extract_features_match_reference(arch):
    """Text-only decoder backbones other than the dense one: rwkv6 (64
    tokens: the chunked wkv) and mixtral (its MoE FFN, no aux read)."""
    fam = Family(arch)
    toks = np.random.default_rng(5).integers(0, fam.cfg.vocab, (6, 64),
                                             dtype=np.int32)
    want = ref_probe.extract_features(fam.rcfg, fam.params_ref, toks, 4)
    got = coded_probe.extract_features(fam.cfg, fam.params, toks, 4,
                                       device="cpu")
    assert got.shape == want.shape == (6, fam.cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_TOL * np.abs(want).max())
